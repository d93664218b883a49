#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (powerserve_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  build      compile csrc/*.cu with nvcc (one process per source), with
             the card's name and power limit
  kernels    an empty hand-written kernel's launch (the floor of every
             row, same timer); each kernel and its plain PyTorch twin on
             the card at the llama-8b main-path shapes (qmatmul: Q4_K at
             the four
             projections, M = 1, 5, 8, 16 and 512, Q4_0 and Q8_0 at
             4096 -> 4096 and M <= 16, with the GB/s reached; every case
             twice, bit for bit; last, M = 1024 at 4096 -> 28672 and a
             speculative verify's M = 40 at the four projections; after
             them the W8 rows below): max error against its tolerance,
             CUDA-event times (warm, L2 flushed by a write, median of 25),
             the bound
             at 3.35 TB/s or 989 TFLOP/s bf16 (W8: 1,979 TOP/s int8;
             attention: over the positions this run's inputs make
             visible; the grouped qmatmul: its routed rows, padding left
             out, and the bytes of the slabs its tile ids name);
             flash-prefill at run's shape, the scheduler's
             bucket and a ragged T (last, the bucket without its long
             slot and `generate`'s last 128-row chunk of a 2048-token
             prompt, each twice bit for bit), paged flash-decode with
             pages of 64
             and 8; the grouped qmatmul at mixtral-lite's prefill, at
             qwen3moe-lite's decode and on the single-token route; the W8
             qmatmul at llama-8b's 4096 -> 28672 for M = 1 and 512 (and,
             after every other row, at the four layer shapes for M = 1
             and 512, the head's 4096 -> 128256 at M = 1 and 4096 ->
             28672 at M = 40 and 1024, then at 4096 -> 28672 for M = 2,
             5, 8, 9 and 16), each twice bit for bit, its
             quantize pass bit-equal to quantize_activations and timed
             alone, torch._int_mm on the same int8 operands beside it; the
             fused linear's modes at llama-8b's draft shapes (x -> wo,
             norm(x + attn_out) -> gate|up, glu + 2 residuals -> down at
             K = 14336, norm + bias -> a qwen2.5-3b QKV, concat2 (and
             with a bias in Q8_0 at the EAGLE head's fc, M = 1 and 5), x +
             argmax -> a factored head's V), each beside the plain GEMV on
             its weight and rows (the fused head too: 4096 -> 128256), and
             the state mode of paged flash-decode (S = 8, Tq = 5, a slot
             that sees nothing), the dense state modes of flash-decode
             (S = 8) and flash-prefill (S = 2, Tq = 128) over the second
             2,048 of 4,096 positions at tp = 2 x sp = 2's 16/4 heads,
             rows that see none of them included, and the dense state
             mode's tree mode there (a [2, 1, 1] verify at S = 3, its
             key positions across the slice's start); last, flash-decode's
             tree mode at a [2, 1, 1] token tree's shapes (a verify and a draft level at
             S = 1 over 2048 positions, the paged verify at S = 8 over
             560-650, each twice bit for bit, SDPA with the same
             visibility for information) and the causal rule's bits
             through the tree mode, dense and paged, then the verify over
             a 1,024-position cache and a one-row decode over the
             verify's 2,048 (the cache length's share of its time against
             its rows'), and a flash_decode_geometry line: each tree row's
             splits, token groups, tiles a warp and clusters the card
             holds at once (cudaOccupancyMaxActiveClusters), beside its
             walk, and the clusters of 1 to 8 blocks the card holds at
             the verify's shared memory; last, the shapes
             perplexity adds: the Q4_K lm_head 4096 -> 128256 as the
             prefill GEMM at M = 32 and 490, and flash-prefill at S = 1,
             Tq = 32 from start 448 over a 490-position cache; last, the
             sampler's draws (csrc/sample.cu) against their twin, 16
             calls a case: the categorical draw at [8, 128256] and [8,
             152064] (tokens equal but within CDF_SLACK of a boundary,
             at most 1% of the rows; torch.multinomial's time beside
             it), a chain's uniforms [8, 4] and a WOR level's Gumbel
             noise [16, 128256], bit for bit
  cli        the `run` entry (greedy, -n 16) on synthetic tiny Q8_0,
             tiny-k Q4_K and tiny-moe Q8_0 workspaces, on cuda and on the
             cpu plain path (tiny and tiny-k also with
             --self-draft-layers 1, with --draft and with --draft <a
             random EAGLE head's dir>, by a chain and by
             --spec-engine device-tree --spec-tree 2,1,1, and with
             --spec-engine tree --draft, whose tokens must be the plain
             run's);
             tokens must agree (a divergence only where the cpu top-2
             logit gap is < 0.5) and every kernel's launch count must
             rise; the logits of the prompt and of each generated token
             fed back one at a time must agree between cuda and cpu; on
             tiny, `run --save-kv` then `run --load-kv` with another
             prompt, whose tokens must be generate's over the saved
             stream and that prompt fed whole (near-tie rule)
  serve      the HTTP server on the same three workspaces, on cuda and cpu,
             with the dense cache and with a paged pool that preempts:
             four concurrent greedy completions and a streamed and a
             plain chat completion; cuda agrees with cpu, paged with
             dense, every request with a lone generate (near-tie rule),
             SSE deltas with the plain reply; the path's kernels launch;
             no request ends in "error" and the scheduler logs no error;
             on tiny and tiny-k also "model+self:1", every request's
             tokens the plain model's
  params     llama-8b Q4_K random weights built on the card
  full_width llama-8b (32 layers): prefill_step over 512 tokens on the
             kernels, and against the same prefill with flash-prefill
             sent to its twin; one decode step on the kernels against
             the same step through the plain twins on the card, the step
             on the kernels under torch.cuda.set_sync_debug_mode("error");
             decode_scan for 64 tokens (argmax head), each step a
             replayed CUDA graph (engine/graphs.py), and its eager twin
             decode_scan_eager on a copy of the cache, twice each (the
             second replayed call under set_sync_debug_mode("error")):
             the same tokens, the cache bit for bit, the same launch
             counts; InferenceEngine.generate for the same 64 tokens
             (logits head), replayed and with every step eager (the
             twin): the same tokens and launch counts. The two token
             streams must agree. The launch counts are zeroed just
             before each path and read just after it, and each path
             must have launched its kernels. Both tok/s of each path,
             the graphs captured, their capture time and pool memory.
  tools_full_width  (after trace) tools/perplexity.py on llama-8b: 490
             seeded ids at batch 32 (15 chunks of 32 on the prefill
             kernels, a last one of 10 on flash-decode and the fused
             head; the four kernels must launch) and at batch 512 (one
             chunk), tok/s of each; 74 ids at batch 32 on the kernels and
             on the plain twins on the card (each row's log-probability
             and the log-perplexity within LOGP_SHARE of their
             magnitudes); dump_forward of 64 ids on the kernels and on the
             twins (every layer's cosine >= DUMP_COS, the logits by the
             near-tie rule)
  tools_cli  the tools as `python -m powerserve_tpu_torch` processes on an
             HF directory at llama-8b's widths (2 layers, a 32,000-token
             vocabulary, BF16 written by tools/safetensors.py, a BPE
             tokenizer.json): convert --quant q8_0 and workspace create;
             then at once perplexity, dump-activations on cuda, run
             --dump-speedinfo, param-search --engine chain
             --self-draft-layers 1, gate (a corpus, --draft self:1, a
             4-question MMLU CSV against the server it starts) and
             bench-kernels; then dump-activations on the cpu and cos-sim
             of the two dumps (every layer >= DUMP_COS); each exiting 0;
             seconds of each
  serve_full_width  llama-8b behind the HTTP server: 8 slots over a paged
             pool of half of 8 x 2048 positions, 8 concurrent greedy
             requests (prompts of 128-1024 tokens, 64 new tokens): all
             finish "length", two agree with a lone generate, the paged
             and prefill kernels launch; generated tok/s, TTFT, peak pages
             and memory. The decode ticks replay their step graphs; the
             same traffic again with every step eager (the twin), each
             request's tokens the replayed run's (near-tie rule), and
             its tok/s and TTFT; the pool's paged_slow_ticks
  sampled_serve  serve_full_width's traffic on one server: greedy, then
             at temperature 0.8 with seeds 0..7 twice (the same replies),
             request 3 alone (its reply beside the seven others'), then
             "model+self:4" at 0.8; every step of a sampled tick a
             graph call, all but each graph's first a replay, and the
             sample kernel launched; tok/s, TTFT, paged_slow_ticks and
             the tick split of each run (CUDA events around every graph
             call of the scheduler's ticks: each tick's replay ms, the
             card's wait between one tick's replays and the next's)
  session_full_width  an HTTP session on llama-8b behind the server: 8
             slots, max_seq 2048, a paged pool of 256 pages of 64; a
             1,536-token preamble pinned as a session, then 8 concurrent
             greedy requests with it and 64-256 tokens of their own (32
             new each): on the pinned snapshot, with the prefix cache
             cleared (a whole re-prefill) and from the session's file
             after DELETE and load_path; every reply the hit's (near-tie
             rule), fewer flash-prefill launches on a hit, TTFT p50/p90
             of each run, the file's bytes, its save and load seconds;
             serve_full_width's traffic alone and beside session loads
             run back to back, the server's (the file inflated in a child
             process) and load_session in the handler thread, in turns
             (generated tok/s and TTFT of each); the session on
             "model+self:4" (its draft prefix pinned too), every reply
             the plain name's
  evict      ServerContext(max_models=2) over three model dirs at
             llama-1b's widths (2 layers, a 32,000-token vocabulary,
             Q8_0, one GGUF written and linked into each): a, b, c, a
             served in turn, one request
             each; every eviction must give back what its context took
             (weights, pool, buffers, snapshots) within 5% of the
             allocated bytes and leave no segment of its graphs' pool;
             allocated and reserved bytes before and after each
  spec_full_width  chain speculation on llama-8b: ChainSpecEngine with a
             4-layer self-draft (the fused layer chain), with a llama-1b
             draft and with a rank-512 factored draft head, k = 4, 512 +
             64 greedy tokens, each against generate's tokens, each
             chain step a replayed graph and each run against its eager
             twin (the same tokens and launch counts; one more replayed
             block of the self-draft under
             set_sync_debug_mode("error"));
             "model+self:4" with serve_full_width's traffic (the paged
             verify through the state mode; its greedy ticks replay
             their chain steps, and against the eager twin); a spec
             tick's parts, eager, and the tick replayed; one paged
             verify through the deferred route against the inline one
             (logits, committed K/V), and an 8-slot paged decode forward
             and that deferred verify under
             set_sync_debug_mode("error"). Acceptance is reported, not
             held (random weights)
  tree_full_width  token trees on llama-8b: DeviceTreeEngine with the
             [2, 1, 1] tree and a 4-layer self-draft, 512 + 64 greedy
             tokens, each tree step a replayed graph, against its eager
             twin (tokens, both caches bit for bit, launch counts; a
             second steady call of each; one more replayed block under
             set_sync_debug_mode("error")) and against generate's
             tokens; the host SpeculativeEngine with a llama-1b draft, 16
             tokens, against generate's
  tree_serve_full_width  "model+self:4" with --spec-tree 2,1,1 on
             serve_full_width's paged pool and traffic (its greedy tree
             ticks replayed, and the eager twin): every reply
             serve_full_width's (near-tie rule), the paged tree mode
             launched by the verify, one more request at temperature 0.8
             with a seed that must not end in "error"
  eagle_full_width  EAGLE speculation on llama-8b: a random EAGLE-1 head
             at EAGLE-LLaMA3-Instruct-8B's widths (Q8_0, one layer, fc
             8192 -> 4096 + bias, no attn_norm on layer 0, the target's
             embedding and lm_head) written as a GGUF and loaded as `run`
             loads it; EagleChainEngine k = 4 and the [2, 1, 1] tree, 512
             + 64 greedy tokens, each step a replayed graph, against the
             eager twin (tokens, both caches, launch counts) and
             generate's tokens; one more replayed chain block under
             set_sync_debug_mode("error"); the exact-replica head (fc =
             [I; 0], the target's layer 0) over a 1-layer target: every
             draft accepted, the tokens that target's generate's
  eagle_serve_full_width  "model+<head dir>" on serve_full_width's pool
             and traffic (its greedy EAGLE ticks replayed, and the eager
             twin): every reply serve_full_width's (near-tie rule), plus
             one request at temperature 0.8 with a seed
  vlm_full_width  InternVL2.5-4B's widths, random weights
             (InternViT-300M-448px: 24 layers of 1024, 16 heads, MLP 4096,
             q/k/v biases, layer scale; the projector 4096 -> 2048 -> 2048;
             Qwen2.5-3B Q4_K): an 896 x 448 PNG written and decoded by the
             port (2 tiles + the thumbnail = 768 image tokens) and 32 text
             tokens through VLMEngine, 64 greedy tokens, twice (the second
             steady); the multimodal prefill (tower, overlay, forward)
             under set_sync_debug_mode("error"), its logits and one decode
             step against the plain twins on the card (near-tie rule); the
             tower on the card against the CPU (one tile, its first 4
             layers, within VISION_REL); the vision ms per tile, the
             multimodal prefill tok/s, the steady decode tok/s and the
             launches of qmatmul, the fused head, flash-prefill and
             flash-decode
  serve_vlm_full_width  that model behind the HTTP server: 8 slots, a
             paged pool of 128 pages of 64, 4 chat requests with such a PNG
             and 4 text completions at once (temperature 0, 64 tokens),
             served twice on fresh servers (the second's tokens the
             first's): every image request's tokens VLMEngine's (near-tie
             rule); image request 0 alone, and on "model+self:4", its
             batched tokens; each serving's generated tok/s, TTFT p50/p90,
             each image's encode ms and the image worker processes' start
  tp_kernels  the kernels at llama-8b's tp = 2 local shapes, each against
             its twin with times and bounds: the GEMV (M = 1, 8) and the
             prefill GEMM (M = 512) at QKV 4096 -> 3072, wo 2048 -> 4096,
             gate|up 4096 -> 14336 and down 7168 -> 4096 (pack group
             1792), the fused head 4096 -> 64128 with and without its
             argmax, flash-decode (S = 1 and 8) and flash-prefill at 16/4
             heads; SDPA beside the attention rows
  tp_full_width  llama-8b Q4_K over two ranks (parallel/tp.py, tp = 2,
             random weights from seed 0 on every rank): NCCL with a card a
             rank where there are two cards, else gloo with both ranks on
             the one card (said in the line); a 512-token prefill and one
             decode step against the single-device forward on the card
             (TP_LOGIT_REL), greedy to 32 tokens against generate's
             (near-tie rule), each rank's launches zeroed before each
             path and read after it, each path's wall time (two ranks on
             one card: a check of function, not of speed). No sync-error
             mode: gloo stages through the host
  serve_tp   the HTTP server over two ranks on tiny Q8_0 and tiny-k Q4_K
             (one context a layout, serving both): the dense cache with
             "model" and "model+self:1", a paged pool that preempts (10
             pages of 8), and tp = 2 x dp = 2 on a pool of 20 pages (four
             ranks on the card); every request's greedy tokens the
             single-device server's (near-tie rule), every rank's
             launches of the path's kernels
  sp_full_width  (after serve_tp; one rank group of four for this and
             the next three phases, gloo on the one card unless there are
             four) llama-8b Q4_K cut to 8 layers over tp = 2 x sp = 2
             (against a single-device twin at that depth), a
             4,096-position cache (2,048 positions a rank): a
             2,100-token prompt in
             three 700-token chunks (the last straddles the slices) and
             16 greedy tokens, each chunk's logits within SP_LOGIT_REL
             of one device's, tokens by the near-tie rule, the cache put
             together (mask, pos and layer 0 bit for bit; the later
             layers' share of equal entries), each rank's launches of
             the state modes; wall times beside one device's
  pp_full_width  llama-8b Q4_K over two pipeline stages (the group's
             first two ranks, 16 layers a stage): a 512-token prefill and
             32 greedy tokens bit for bit one device's (logits, tokens,
             the cache put together), tok/s beside one device's, the ms
             of one hop of the residual ([1, 1], [8, 1] and [1, 512]
             rows of 4096), and pp_prefill_microbatched of 8 x 128
             tokens in 4 microbatches beside 1
  serve_pp_sp  the HTTP server over that group with both models: 4
             concurrent greedy completions of 204-2,457 prompt tokens to
             "pp", the shortest and the longest to "sp" (8 layers), every
             reply a lone generate's (near-tie rule), each rank's
             launches, generated tok/s
  sp_compositions_full_width  the scheduler over that group's tp = 2 x
             sp = 2 ranks, a 512-position cache (256 a rank), at full
             widths: llama-8b (its 8 layers) with the 4-layer
             self-draft's [2, 1, 1]
             tree, with the random EAGLE head's chain and [2, 1, 1] tree
             (a 253-token prompt: the first tree straddles position
             256), mixtral-lite cut to 8 layers, InternVL2.5-4B (text
             cut to 8 layers) with one 448 x 448 PNG whose rows cross
             256; 8 greedy tokens each against the single device's
             (near-tie rule), each rank's launches of the path's
             kernels (the state mode's tree mode in the verifies), the
             cuts printed
  moe_full_width  mixtral-lite Q4_K (32 layers, 8 experts of width 3584,
             top-2): InferenceEngine.generate of a 512-token prompt and 64
             greedy tokens (the grouped prefill, the single-token route;
             replayed, and against its eager twin), decode_scan for the
             same 64 tokens against decode_scan_eager (tokens, cache and
             launch counts),
             one S = 8 decode step (grouped, block_m 16) on the kernels
             against the plain twins on the card; qwen3moe-lite (128
             experts, top-8, 4 layers): one S = 8 decode step (grouped,
             block_m 16) and one 512-token prefill (grouped, block_m 128)
             against the twins;
             every route of the MoE FFN once under
             torch.cuda.set_sync_debug_mode("error")
  serve_moe_full_width  mixtral-lite behind the HTTP server, with the
             traffic of serve_full_width (and its eager twin)
  w8_full_width  llama-8b in the W8 format: the full_width paths; every
             projection and the lm_head go through the W8 kernel and the
             fused head never launches; every W8 product of the 512-token
             prefill and of the decode step against the W8 twin on its
             own input; the a8 codes that differ between the step on the
             kernels and on the twins, layer by layer (each product's
             input quantized by quantize_activations); the prefill and
             the decode step under set_sync_debug_mode("error")
  w8_requantized  the same, on llama-8b Q4_K weights requantized to W8
             (core/quant.py's requantize_w8 on the card), held end to
             end as full_width is: the prefill and the decode step
             against the twins within LOGIT_REL
  weight_format  (after cli) `run --weight-format w8` on tiny-k Q4_K on
             cuda and on the cpu: tokens agree (near-tie rule), the W8
             kernel launched, the fused head and the GGUF qmatmul not
  trace      (after full_width) first the paged plain tick's
             device-to-host copies under torch.profiler (8 slots, pages
             of 64; the process's first profiler session), which must be
             1; then llama-8b generate untraced and under
             core/trace.py's Trace: the same tokens, one prefill span a
             chunk and one decode_step span a block, the port's kernels
             among the trace's kernel events, decode tok/s traced and
             not
  w8_moe_full_width  (after serve_moe_full_width) mixtral-lite in W8:
             the grouped mode of csrc/qmatmul_w8.cu on layer 0's slabs
             at the gate and down shapes of a 512-token prefill (block_m
             128), 32 and 8 decoding slots (block_m 16) and one token
             (block_m 1), each against its twin within 1e-4, twice bit
             for bit, timed beside the Q4_K grouped mode at the same
             routing; generate (512 + 64, replayed, a first and a steady
             call); an S = 8 decode step with every W8 product held
             against its twin, then timed eager and replayed (CUDA
             events) with its launches; each MoE route under
             set_sync_debug_mode("error")
  vlm_hf_dir  (after serve_vlm_full_width) an HF InternVL checkpoint dir
             at InternVL2.5-4B's widths and 151,936-token vocabulary, 2
             text and 2 vision layers, BF16 safetensors written by the port's own writer: `run --image
             <the JPEG fixture>` on the dir as it is gives the tokens of
             `run` on its `convert --quant q8_0` workspace
  serve_tp_vlm  the server over tp = 2 ranks with an InternVL2.5-4B-width
             VLM (text cut to 8 layers over the ranks, the tower on rank
             0): a JPEG chat and a text completion, replies the single-
             device server's (near-tie rule), each rank's launches
  tp_moe_kernels  the grouped qmatmul at mixtral-lite's local expert
             shapes at tp = 2 (8 slabs of 4096 -> 1792 / 1792 -> 4096)
             and ep = 2 (4 slabs a rank), prefill, decode and single
             token, against the twins with times and bounds
  tp_moe_full_width  mixtral-lite Q4_K cut to 8 layers over two ranks,
             tp = 2 and ep = 2: prefill and decode-step logits against
             one device's, 16 greedy tokens, and a served run against the
             single-device server, each rank's launches
  tp_eagle_full_width  llama-8b Q4_K cut to 8 layers with a random EAGLE
             head over tp = 2 ranks: the scheduler's chain and tree
             ticks against one device's and generate's tokens, and the
             exact-replica head over the 1-layer target's shards (every
             draft accepted)
  native     (last) core/native.py: a llama-8b-width Q4_K GGUF (4 layers,
             a 32,000-token tied vocabulary) loaded onto the card with
             the C++ repack and with the numpy twin, bit for bit, seconds
             of each; a ~2,048-token prompt tokenized by the C++ merge
             loop and by the Python loop, the same ids, ms of each
Then a summary line (decode tok/s of full_width, w8_full_width and
mixtral-lite, generated tok/s of the serve phases, spec_full_width's
tok/s, each replayed and its eager twin's), the kernels line (launch
counts from each kernel's own path: the
llama-8b generate for the first slice's kernels, serve_full_width for
flash-prefill and paged flash-decode, mixtral-lite's generate for the
grouped qmatmul, the W8 generate for the W8 qmatmul, spec_full_width for
the fused-linear modes and the state mode, tree_full_width's device tree
for the tree mode, tree_serve_full_width for the paged tree mode and
eagle_full_width's chain for concat2, w8_moe_full_width's steady
generate for the grouped W8 mode, sampled_serve's first sampled run for
the sample kernel, rank 0's sp_full_width decode and last prefill chunk
for the dense state modes, and rank 0's self-draft tree in
sp_compositions_full_width for the state mode's tree mode), the card's
nvidia-smi line and, last, {"ok": true, "device": ...}.

Any failure raises and exits non-zero; so does a machine without CUDA.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --kernels [--read-flush]
       python3 chip_smoke.py --vlm
       python3 chip_smoke.py --tp
       python3 chip_smoke.py --ticks
       python3 chip_smoke.py --tools
       python3 chip_smoke.py --compose
       python3 chip_smoke.py --sampled
       python3 chip_smoke.py --pp-sp
       python3 chip_smoke.py --w8
       python3 chip_smoke.py --trees
The second form runs the build, kernels and tp_kernels phases only (the
L2 flushed by reading 256 MB with --read-flush) and prints the card's
line last; the third the build, the two VLM phases and vlm_hf_dir; the
seventh the build, tp_kernels and the rank-group compositions (tp_moe_
kernels, tp_moe_full_width, serve_tp_vlm, tp_eagle_full_width) and
vlm_hf_dir; the fourth the
build and the three tensor-parallel phases; the fifth the build and the
paged plain tick's device-to-host copies on llama-8b (the scheduler's
public surface only, so a copy of this script counts a parent tree's);
the sixth the build and the two tools phases; the eighth the build,
llama-8b's parameters and sampled_serve (copied into an older tree, it
measures that tree's serving with the checks of in-graph draws off); the
ninth the build, the kernels phase, llama-8b's parameters, the three
pp/sp phases and sp_compositions_full_width, then the card's line and the
state modes' kernel rows; the tenth the build, the kernels phase and
w8_moe_full_width, then the card's line; the eleventh the build,
llama-8b's parameters, tree_full_width and tree_serve_full_width twice
(without serve_full_width's replies to hold it to), then the card's line.
Copied into an unpacked archive of another commit and run there, it
times that commit's kernels at the same cases.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import logging
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak
NEAR_TIE = 0.5  # the reference's greedy near-tie gap
# logits of a whole forward on the kernels against the plain path, as a
# share of the plain logits' range: each kernel agrees with its twin to
# f32 rounding, but the bf16 roundings of the residual stream and of
# every matmul input may then fall the other way (2^-8 of one element
# each) and carry through the layers
LOGIT_REL = 1e-2
# the vision tower on the card against the CPU, as a share of the range:
# their bf16 products sum in other orders, so a bf16 rounding may fall
# the other way (2^-8 of one element) and carry through the layers
VISION_REL = 2e-2
# logits over two ranks against one device, as a share of the range: the
# rows of wo and down are summed in two f32 partial sums, then added, in
# another order than one product's, so a bf16 rounding of the residual
# stream may fall the other way and carry through the layers (LOGIT_REL's
# reason)
TP_LOGIT_REL = 1e-2


_EMITTED = [time.perf_counter()]


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also gets phase_s, the seconds since
    the line before it (the phase's own wall time, its build included)."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_s": now - _EMITTED[0]}
    _EMITTED[0] = now
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


class Timer:
    """CUDA-event time of one call, warm, with the L2 cache flushed and
    the GPU kept busy while the host enqueues the call. The flush writes
    256 MB; with read_flush it reads them instead, so the L2 holds clean
    lines and no write-back of the flush's dirty ones falls into the
    timed call."""

    def __init__(self, dev: torch.device, read_flush: bool = False):
        self.flush = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
        self.read_flush = read_flush

    def __call__(self, fn, reps: int = 25) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if self.read_flush:
                self.flush.view(torch.float32).sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(50_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_kernels(dev: torch.device, read_flush: bool = False) -> list[dict]:
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.flash_decode import (
        decode_visibility, flash_decode_cuda, flash_decode_paged_cuda,
        flash_decode_paged_reference, flash_decode_quant_reference,
        gather_pages, kernel_walk)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_cuda, flash_prefill_quant_reference, prefill_visibility)
    from powerserve_tpu_torch.ops.fused import (fused_linear_cuda,
                                                fused_linear_reference,
                                                glu_rounding_slack,
                                                norm_rounding_slack,
                                                prologue_reference)
    from powerserve_tpu_torch.ops import qmatmul as qm
    from powerserve_tpu_torch.ops.moe import group_dispatch
    from powerserve_tpu_torch.ops.qmatmul import (
        qmatmul_cuda, qmatmul_grouped_cuda, qmatmul_grouped_reference,
        qmatmul_reference, qmatmul_w8_cuda, qmatmul_w8_reference,
        quantize_activations)
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    # the W8 quantize pass alone (absent from trees before it, whose W8
    # rows this script still times when copied into them)
    quant_pass = getattr(qm, "quantize_activations_cuda", None)
    # flash-decode's launch geometry (absent from trees before it) beside
    # the twin's walk (end, tokens a warp)
    fd_mod = sys.modules["powerserve_tpu_torch.ops.flash_decode"]
    geometry_of = getattr(fd_mod, "launch_geometry", None)

    def fd_geometry(q, Hkv_, T_, J, vis, page_=0, tree=True, state=False):
        S_, Tq_, H_, D_ = q.shape
        out = ({} if geometry_of is None else geometry_of(
            S_, Hkv_, H_ // Hkv_, Tq_, T_, D_, J, page_, tree))
        end, per_warp = kernel_walk(vis, Hkv_, H_ // Hkv_, state)
        return dict(out, end=end.tolist(), tokens_per_warp=per_warp.tolist())

    timer = Timer(dev, read_flush)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    # the floor of every row: one empty hand-written kernel, same timer
    lib = cuda_lib.lib()
    empty_ms = timer(lambda: cuda_lib.check(
        lib.ps_empty_launch(cuda_lib.stream(dev)), "empty launch"))

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def check(name, got, ref, rel_tol, slack=0.0):
        err = (got.float() - ref.float()).abs()
        tol = rel_tol * max(1.0, ref.float().abs().max().item()) + slack
        if not (err <= tol).all():
            raise AssertionError(f"{name}: max abs err {err.max().item()}, "
                                 f"{(err - tol).max().item()} over tolerance")
        return err.max().item()

    def flips_check(name, got, ref, vs, rel_tol=1e-4):
        """Attention over the int8 cache: kernel and twin sum the f32
        scores in another order, so p * vs, rounded to bf16 before the
        value product, may round the other way next to a midpoint. Each
        such flip moves a whole head row by one bf16 ulp of that term,
        and all of them together by at most 2^-8 * 127 * max vs. At most
        1 in 100 outputs may exceed rel_tol, none by more than that."""
        err = (got.float() - ref.float()).abs()
        tol = rel_tol * max(1.0, ref.float().abs().max().item())
        flip = 2.0 ** -8 * 127 * vs.float().abs().max().item()
        over = (err > tol).float().mean().item()
        if over > 1e-2 or not (err <= tol + flip).all():
            raise AssertionError(f"{name}: max abs err {err.max().item()}, "
                                 f"{over} of outputs over {tol}")
        return err.max().item()

    def cache(S, Hkv, T, D):
        """Random int8 K/V [S, Hkv, T, D] and f32 scales [S, Hkv, T]."""
        kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
                  for _ in range(2))
        return kq, ks, vq, vs

    # -- qmatmul: Q4_K (bf16 scales + mins, packed) at the four 8B
    #    projection shapes, at the decode GEMV's M (1: run, 5: a chain
    #    verify of k = 4, 8: a serving tick, 16) and prefill's 512; Q4_0 and
    #    Q8_0 at 4096 -> 4096 and the GEMV's M. Tolerance: f32 sums in
    #    another order; the GEMV also gives the same bits twice.
    qmm_rows = []
    gemv_m = (1, 5, 8, 16)
    cases = [("q4_k", k, n, gemv_m + (512,))
             for k, n in ((4096, 6144), (4096, 4096), (4096, 28672),
                          (14336, 4096))]
    cases += [("q4_0", 4096, 4096, gemv_m), ("q8_0", 4096, 4096, gemv_m)]
    for quant, k, n, ms_ in cases:
        lin = _rand_qlinear(g, k, n, quant, dev)
        for m in ms_:
            x = randn(m, k, dtype=torch.bfloat16)
            ref = qmatmul_reference(x, lin)
            got = qmatmul_cuda(x, lin)
            err = check(f"qmatmul {quant} {m}x{k}x{n}", got, ref, 1e-4)
            if not torch.equal(got, qmatmul_cuda(x, lin)):
                raise AssertionError(f"qmatmul {quant} {m}x{k}x{n}: two runs "
                                     f"gave different bits")
            ms = timer(lambda: qmatmul_cuda(x, lin))
            plain = timer(lambda: qmatmul_reference(x, lin), reps=20)
            moved = nbytes(x) + lin.nbytes() + m * n * 4
            b, by = bound_ms(moved, 2.0 * m * n * k)
            qmm_rows.append(dict(quant=quant, m=m, k=k, n=n, max_abs_err=err,
                                 ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, gb_s=moved / ms / 1e6))
            del x, ref, got
        del lin
    # a loader-style weight: f32 scales, unpacked int8
    lin = _rand_qlinear(g, 4096, 4096, "q8_0", dev)
    lin.scales = lin.scales.float()
    x = randn(1, 4096, dtype=torch.bfloat16)
    check("qmatmul q8_0 f32 scales", qmatmul_cuda(x, lin),
          qmatmul_reference(x, lin), 1e-4)

    # -- fused head: llama-8b lm_head, Q4_K, vocab 128256, M = 1 and 4
    head = _rand_qlinear(g, 4096, 128256, "q4_k", dev)
    nw = torch.rand(4096, generator=g, device=dev) + 0.5
    head_rows = []
    for m in (1, 4):
        h = randn(m, 4096, dtype=torch.bfloat16) * 3
        ref = fused_linear_reference(head, norm=(h, nw))
        # tolerance: f32 sums in another order, plus the logits that an
        # element of the bf16-rounded normalized rows next to a rounding
        # midpoint moves if the f32 norm's last bits differ
        logits = fused_linear_cuda(head, "norm", [h], nw)
        err = check(f"fused head logits M={m}", logits, ref, 1e-4,
                    norm_rounding_slack(head, h, nw))
        tok = fused_linear_cuda(head, "norm", [h], nw, argmax=True)
        if not torch.equal(tok, logits.argmax(dim=-1).to(torch.int32)):
            raise AssertionError(f"fused head argmax {tok.tolist()} is not "
                                 f"the first maximum of its logits")
        wbytes = nbytes(h, nw) + head.nbytes()
        # the plain GEMV on the same weight and rows (the normalized x)
        xh = prologue_reference("norm", [h], nw)
        for argmax in (False, True):
            ms = timer(lambda: fused_linear_cuda(head, "norm", [h], nw,
                                                 argmax=argmax))
            gemv = timer(lambda: qmatmul_cuda(xh, head))
            plain = timer(lambda: fused_linear_reference(
                head, norm=(h, nw), argmax=argmax), reps=20)
            out_b = m * 4 if argmax else m * 128256 * 4
            b, by = bound_ms(wbytes + out_b, 2.0 * m * 128256 * 4096)
            head_rows.append(dict(m=m, argmax=argmax, max_abs_err=err, ms=ms,
                                  gemv_ms=gemv, plain_ms=plain, bound_ms=b,
                                  bound_by=by))
    del head

    # -- flash decode: llama-8b heads, S = 1, T = 1024 all visible (1023
    #    committed, the new row at 1023); and a ragged T with a partial
    #    prefix, Tq = 2 rows and a slot whose rows see nothing
    #    (correctness)
    fd_rows = []
    scale = 1.0 / 128 ** 0.5
    for S, Tq, T, ragged in ((1, 1, 1024, False), (2, 2, 1000, True)):
        H, Hkv, D = 32, 8, 128
        q = randn(S, Tq, H, D)
        kq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                           dtype=torch.int8)
        vq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
        vs = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
        mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
        pos = torch.tensor([[T - Tq + j for j in range(Tq)]] * S,
                           dtype=torch.int32, device=dev)
        mask[:, :T - Tq] = True
        if ragged:
            mask[0, 700:] = False
            mask[1] = False  # slot 1's rows see nothing
            pos[1] = torch.tensor([-1, T + 5])
        vis = decode_visibility(mask, pos, Tq)
        args = (q, kq, ks, vq, vs, mask, pos, scale)
        ref = flash_decode_quant_reference(*args)
        err = check(f"flash_decode S={S} Tq={Tq} T={T}",
                    flash_decode_cuda(*args), ref, 1e-4)
        ms = timer(lambda: flash_decode_cuda(*args))
        plain = timer(lambda: flash_decode_quant_reference(*args), reps=20)
        # informational: SDPA over bf16 K/V dequantized outside the timing
        qh = q.permute(0, 2, 1, 3).to(torch.bfloat16)
        kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(H // Hkv, dim=1)
                  for c, sc in ((kq, ks), (vq, vs)))
        sdpa = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=vis[:, None]))
        b, by = bound_ms(nbytes(q, kq, vq, ks, vs, mask, pos)
                         + S * Tq * H * D * 4, 4.0 * S * Tq * H * T * D)
        fd_rows.append(dict(S=S, Tq=Tq, T=T, max_abs_err=err, ms=ms,
                            plain_ms=plain, bound_ms=b, bound_by=by,
                            sdpa_bf16_dequantized_ms=sdpa))
    def sdpa_ms(q, kq, ks, vq, vs, vis):
        """Informational: SDPA over bf16 K/V dequantized outside the
        timing, one call (not used by the port)."""
        H, Hkv = q.shape[2], kq.shape[1]
        qh = q.permute(0, 2, 1, 3).to(torch.bfloat16)
        kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(H // Hkv, dim=1)
                  for c, sc in ((kq, ks), (vq, vs)))
        return timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=vis[:, None]))

    def attn_bound(q, vis, Hkv, extra_bytes):
        """Least time for attention over the visible positions only: q
        and out once, each K/V row (2 * D int8 + 2 f32 scales) of a
        position some row sees once, 4 * D operations per (row, head,
        visible position)."""
        S, Tq, H, D = q.shape
        cols = int(vis.any(dim=1).sum())
        return bound_ms(2 * nbytes(q) + cols * Hkv * (2 * D + 8)
                        + extra_bytes, 4.0 * D * H * float(vis.sum()))

    # -- flash prefill: run's shape (S = 1, Tq = 512, start 0), the
    #    scheduler's bucket (S = 8, Tq = 128, varied starts, -1 included, a
    #    committed prefix, decoding slots' committed positions) and a ragged
    #    T with D = 64 (correctness; tolerance: 1e-4 plus rare bf16 flips of
    #    p * vs, see flips_check)
    fp_rows = []
    H, Hkv, D, T = 32, 8, 128, 2048
    fp_cases = [
        ("run", 1, 512, T, 128, [0], [0]),
        ("bucket", 8, 128, T, 128, [0, 128, -1, 512, 40, 1000, -1, 1900],
         [0, 128, 300, 512, 40, 1000, 0, 1900]),
        ("ragged", 3, 100, 1000, 64, [0, 37, -1], [0, 37, 600]),
    ]
    for name, S, Tq, Tc, Dc, starts, committed in fp_cases:
        Hc, Hkvc = (32, 8) if Dc == 128 else (14, 2)
        q = randn(S, Tq, Hc, Dc)
        kq, ks, vq, vs = cache(S, Hkvc, Tc, Dc)
        mask = (torch.arange(Tc, device=dev)[None, :]
                < torch.tensor(committed, device=dev)[:, None])
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        args = (q, kq, ks, vq, vs, mask, start, 1.0 / Dc ** 0.5)
        ref = flash_prefill_quant_reference(*args)
        err = flips_check(f"flash_prefill {name}", flash_prefill_cuda(*args),
                          ref, vs)
        row = dict(case=name, S=S, Tq=Tq, T=Tc, D=Dc, starts=starts,
                   committed=committed, max_abs_err=err)
        if name != "ragged":
            vis = prefill_visibility(mask, start, Tq)[..., :Tc]
            b, by = attn_bound(q, vis, Hkvc, nbytes(mask, start))
            row.update(
                ms=timer(lambda: flash_prefill_cuda(*args)),
                plain_ms=timer(lambda: flash_prefill_quant_reference(*args),
                               reps=5),
                bound_ms=b, bound_by=by,
                visible_positions=int(vis.sum()),
                sdpa_bf16_dequantized_ms=sdpa_ms(q, kq, ks, vq, vs, vis))
        fp_rows.append(row)
        del q, kq, vq, ref

    # -- paged flash decode: S = 8, Tq = 1, ~600 filled positions per slot
    #    of 2048, pages scrambled through the pool with unallocated
    #    entries; pages of 64 (timed) and of 8 (correctness)
    fdp_rows = []
    for page in (64, 8):
        S, Tq, MP = 8, 1, T // page
        filled = [560 + 13 * s for s in range(S)]
        n_alloc = [-(-(f + 1) // page) for f in filled]
        P = sum(n_alloc) + 8
        perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
        pt = torch.full((S, MP), P, dtype=torch.int32, device=dev)
        used = 0
        for s_, n in enumerate(n_alloc):
            pt[s_, :n] = perm[used:used + n]
            used += n
        q = randn(S, Tq, H, D)
        kp, ksp, vp, vsp = cache(P, Hkv, page, D)
        # the committed positions, and the new row at filled[s]
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.tensor(filled, device=dev)[:, None])
        pos = torch.tensor(filled, dtype=torch.int32, device=dev)[:, None]
        vis = decode_visibility(mask, pos, Tq)
        args = (q, kp, ksp, vp, vsp, pt, mask, pos, scale)
        ref = flash_decode_paged_reference(*args)
        err = flips_check(f"flash_decode_paged page={page}",
                          flash_decode_paged_cuda(*args), ref, vsp)
        row = dict(page=page, S=S, Tq=Tq, T=T, filled=filled,
                   max_abs_err=err)
        if page == 64:
            b, by = attn_bound(q, vis, Hkv, nbytes(mask, pos, pt))
            row.update(
                ms=timer(lambda: flash_decode_paged_cuda(*args)),
                plain_ms=timer(lambda: flash_decode_paged_reference(*args),
                               reps=20),
                bound_ms=b, bound_by=by,
                sdpa_bf16_dequantized_ms=sdpa_ms(
                    q, *(gather_pages(t, pt) for t in (kp, ksp, vp, vsp)),
                    vis),
                geometry=fd_geometry(q, Hkv, T, Tq, vis, page, False))
        fdp_rows.append(row)

    # -- grouped qmatmul (the MoE expert FFN), Q4_K stacks with bf16
    #    scales: mixtral-lite's prefill gate projection (512 tokens routed
    #    top-2 over 8 experts by a seeded softmax, block_m 128), qwen3moe-
    #    lite's decode gate projection (8 tokens, top-8 of 128, block_m
    #    16) and the single-token route (one token, its 2 routed slabs as
    #    one-row tiles). Tolerance: f32 sums in another order. Bound: the
    #    routed rows of x and of out once (n_tok * k of the P rows; the
    #    rest is padding that combine weighs by 0), the tile ids, the bytes
    #    of the distinct slabs the ids name; 2 * n_tok * k * N * K
    #    operations
    grp_rows = []
    for case, E, k, n_tok, K, N, bm in (
            ("mixtral-lite prefill gate", 8, 2, 512, 4096, 3584, 128),
            ("qwen3moe-lite decode gate", 128, 8, 8, 2048, 768, 16),
            ("mixtral-lite single token", 8, 2, 1, 4096, 3584, 1)):
        stack = _rand_qlinear(g, K, N, "q4_k", dev, experts=E)
        topw, topi = torch.softmax(randn(n_tok, E), dim=-1).topk(k, dim=-1)
        if bm == 1:
            ids = topi[0].to(torch.int32)
            x = randn(1, K, dtype=torch.bfloat16).expand(k, K).contiguous()
        else:
            tok, _, ids = group_dispatch(topi, topw, E, 0, bm)
            x = randn(n_tok, K, dtype=torch.bfloat16)[tok.clamp(min=0).long()]
        ref = qmatmul_grouped_reference(x, stack, ids, bm)
        got = qmatmul_grouped_cuda(x, stack, ids, bm)
        err = check(f"qmatmul_grouped {case}", got, ref, 1e-4)
        if not torch.equal(got, qmatmul_grouped_cuda(x, stack, ids, bm)):
            raise AssertionError(f"qmatmul_grouped {case}: two runs gave "
                                 f"different bits")
        distinct = int(ids.unique().numel())
        routed = n_tok * k
        b, by = bound_ms(routed * K * x.element_size() + nbytes(ids)
                         + distinct * stack.nbytes() // E + routed * N * 4,
                         2.0 * routed * N * K)
        grp_rows.append(dict(
            case=case, experts=E, top_k=k, tokens=n_tok, P=x.shape[0],
            routed_rows=routed, block_m=bm, k=K, n=N,
            distinct_slabs=distinct, max_abs_err=err,
            ms=timer(lambda: qmatmul_grouped_cuda(x, stack, ids, bm)),
            plain_ms=timer(lambda: qmatmul_grouped_reference(x, stack, ids,
                                                             bm), reps=5),
            bound_ms=b, bound_by=by))
        del stack, x, ref

    def w8_row(lin, m, k, n):
        """A timed W8 product (the wrapper: quantize pass and product):
        against its twin at 1e-4 of the largest output (exact int32 block
        dots, f32 sums over blocks in another order), twice bit for bit;
        its pass bit-equal to quantize_activations and timed alone;
        torch._int_mm on the same int8 operands for information (no
        per-128 scales: not the same function). Bound: operations at the
        int8 tensor-core peak, or the bytes."""
        x = randn(m, k, dtype=torch.bfloat16)
        got = qmatmul_w8_cuda(x, lin)
        err = check(f"qmatmul_w8 {m}x{k}x{n}", got,
                    qmatmul_w8_reference(x, lin), 1e-4)
        if not torch.equal(got, qmatmul_w8_cuda(x, lin)):
            raise AssertionError(f"qmatmul_w8 {m}x{k}x{n}: two runs gave "
                                 f"different bits")
        x8, sx = quantize_activations(x)
        row = dict(m=m, k=k, n=n, max_abs_err=err)
        if quant_pass is not None:
            p8, psx = quant_pass(x)
            if not (torch.equal(p8, x8) and torch.equal(psx, sx)):
                raise AssertionError(
                    f"qmatmul_w8 {m}x{k}x{n}: the quantize pass differs from "
                    f"quantize_activations in {int((p8 != x8).sum())} codes "
                    f"and {int((psx != sx).sum())} scales")
            row.update(pass_bit_equal=True,
                       pass_ms=timer(lambda: quant_pass(x)))
        try:
            int_mm_ms = timer(lambda: torch._int_mm(x8, lin.q))
        except RuntimeError as e:  # shapes cuBLASLt's int8 GEMM refuses
            int_mm_ms = f"refused: {str(e).splitlines()[0][:120]}"
        b, by = bound_ms(nbytes(x) + lin.nbytes() + m * n * 4,
                         2.0 * m * n * k, peak=INT8_OP_PER_S)
        row.update(ms=timer(lambda: qmatmul_w8_cuda(x, lin)),
                   plain_ms=timer(lambda: qmatmul_w8_reference(x, lin),
                                  reps=5),
                   bound_ms=b, bound_by=by, int_mm_ms=int_mm_ms,
                   ops_peak="1979 TOP/s int8")
        return row

    # -- W8 qmatmul: llama-8b's 4096 -> 28672 in the W8 format, M = 1 and
    #    512 (more shapes at the end)
    w8_rows = []
    lin8 = _rand_qlinear(g, 4096, 28672, "w8", dev)
    for m in (1, 512):
        w8_rows.append(w8_row(lin8, m, 4096, 28672))
    del lin8

    # -- fused linear, the rest of the TPU kernel's modes, at the widths
    #    of llama-8b's fused decode-layer chain and factored draft head
    #    (Q4_K or Q8_0 with bf16 scales): x -> wo, norm(x + attn_out) ->
    #    gate|up, glu + both residuals -> down (K = 14336), norm + bias ->
    #    a qwen2.5-3b QKV, concat2 (2 x 4096 -> 4096, the EAGLE fc input;
    #    with its bias in Q8_0, the EAGLE-LLaMA3-8B head's, at a draft's
    #    M = 1 and a re-prefill's M = 5), x + argmax -> the factored
    #    head's V (512 -> 128256). Tolerance:
    #    1e-4 of the largest output plus the norm/glu rounding slacks.
    #    Bound: operands, weights, bias, residuals and output once;
    #    2 * M * N * K operations
    fl_rows = []
    fl_cases = [  # name, prologue, M, K, N, quant, n_ops, bias, resids, argmax
        ("x wo", "x", 1, 4096, 4096, "q4_k", 1, False, 0, False),
        ("x wo", "x", 8, 4096, 4096, "q4_k", 1, False, 0, False),
        ("norm(x+attn) gate|up", "norm", 8, 4096, 28672, "q4_k", 2, False, 0,
         False),
        ("glu+2 resids down", "glu", 8, 14336, 4096, "q4_k", 1, False, 2,
         False),
        ("norm+bias qwen2.5-3b qkv", "norm", 1, 2048, 2560, "q4_k", 1, True,
         0, False),
        ("concat2 eagle fc", "concat2", 8, 8192, 4096, "q4_k", 2, False, 0,
         False),
        # the EAGLE fc as its head has it (Q8_0 + bias): a draft, a
        # re-prefill
        ("concat2+bias eagle fc q8_0", "concat2", 1, 8192, 4096, "q8_0", 2,
         True, 0, False),
        ("concat2+bias eagle fc q8_0", "concat2", 5, 8192, 4096, "q8_0", 2,
         True, 0, False),
        ("x+argmax factored head V", "x", 5, 512, 128256, "q8_0", 1, False, 0,
         True),
    ]
    for name, pro, m, k, n, quant, n_ops, has_bias, n_res, argmax in fl_cases:
        lin = _rand_qlinear(g, k, n, quant, dev)
        widths = {"glu": [2 * k], "concat2": [k // 2, k // 2]}.get(
            pro, [k] * n_ops)
        dts = [torch.bfloat16, torch.float32]  # the residual stream, attn_out
        ops = [(randn(m, w) * 2).to(dts[i % 2]) for i, w in enumerate(widths)]
        nw = torch.rand(k, generator=g, device=dev) + 0.5
        nw = nw if pro == "norm" else None
        bias = randn(n) if has_bias else None
        resids = [randn(m, n).to(dts[i % 2]) for i in range(n_res)]
        kw = dict(bias=bias, resids=resids)
        kw.update({"x": dict(x=ops[0]), "norm": dict(norm=(*ops, nw)),
                   "glu": dict(glu=ops[0]),
                   "concat2": dict(parts=tuple(ops))}[pro])
        ref = fused_linear_reference(lin, **kw)
        got = fused_linear_cuda(lin, pro, ops, nw, bias, resids)
        slack = 0.0
        if pro == "norm":
            slack = norm_rounding_slack(lin, *ops, nw)
        elif pro == "glu":
            slack = glu_rounding_slack(lin, ops[0])
        err = check(f"fused_linear {name} M={m}", got, ref, 1e-4, slack)
        if argmax:
            tok = fused_linear_cuda(lin, pro, ops, nw, bias, resids, True)
            if not torch.equal(tok, got.argmax(dim=-1).to(torch.int32)):
                raise AssertionError(f"fused_linear {name}: argmax {tok} is "
                                     f"not the first maximum of its output")
        b, by = bound_ms(nbytes(*ops, *resids) + lin.nbytes()
                         + (nbytes(bias) if has_bias else 0)
                         + (m * 4 if argmax else m * n * 4), 2.0 * m * n * k)
        x = prologue_reference(pro, ops, nw)  # the plain GEMV's input
        fl_rows.append(dict(
            case=name, prologue=pro, m=m, k=k, n=n, quant=quant,
            argmax=argmax, max_abs_err=err,
            ms=timer(lambda: fused_linear_cuda(lin, pro, ops, nw, bias,
                                               resids, argmax)),
            gemv_ms=timer(lambda: qmatmul_cuda(x, lin)),
            plain_ms=timer(lambda: fused_linear_reference(
                lin, argmax=argmax, **kw), reps=5),
            bound_ms=b, bound_by=by))
        del lin, ops, ref, got

    # -- paged flash-decode, state mode (the paged verify of speculation):
    #    S = 8 slots, Tq = 5 rows each, pages of 64, a scrambled table; the
    #    last slot sees no committed position (its m must stay <= -1e30/2,
    #    so the deferred merge weighs it 0). Tolerance: m to f32
    #    rounding, l 1e-4, o as flips_check
    S, Tq, page = 8, 5, 64
    MP = T // page
    filled = [560 + 13 * s_ for s_ in range(S - 1)] + [0]
    n_alloc = [-(-f // page) for f in filled]
    P = sum(n_alloc) + 8
    perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
    pt = torch.full((S, MP), P, dtype=torch.int32, device=dev)
    used = 0
    for s_, n_ in enumerate(n_alloc):
        pt[s_, :n_] = perm[used:used + n_]
        used += n_
    q = randn(S, Tq, H, D)
    kp, ksp, vp, vsp = cache(P, Hkv, page, D)
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor(filled, device=dev)[:, None])
    vis = decode_visibility(mask, None, Tq)
    args = (q, kp, ksp, vp, vsp, pt, mask, None, scale)
    o, m_, l_ = flash_decode_paged_cuda(*args, state=True)
    ro, rm, rl = flash_decode_paged_reference(*args, state=True)
    seen = torch.tensor([f > 0 for f in filled], device=dev)
    if not (m_[~seen] <= -0.5e30).all():
        raise AssertionError("state mode: an empty slot's m is above -1e30/2")
    check("flash_decode_paged state m", m_[seen], rm[seen], 1e-6)
    check("flash_decode_paged state l", l_[seen], rl[seen], 1e-4)
    err = flips_check("flash_decode_paged state o", o[seen], ro[seen], vsp)
    b, by = attn_bound(q, vis, Hkv, nbytes(mask, pt) + nbytes(m_, l_))
    state_row = dict(
        S=S, Tq=Tq, T=T, page=page, filled=filled, max_abs_err=err,
        ms=timer(lambda: flash_decode_paged_cuda(*args, state=True)),
        plain_ms=timer(lambda: flash_decode_paged_reference(*args,
                                                            state=True),
                       reps=20),
        bound_ms=b, bound_by=by,
        sdpa_bf16_dequantized_ms=sdpa_ms(
            q, *(gather_pages(t, pt) for t in (kp, ksp, vp, vsp)),
            vis | ~seen[:, None, None]),
        geometry=fd_geometry(q, Hkv, T, Tq, vis, page, False, True))
    del q, kp, vp, o, ro

    # -- the dense state modes (sequence parallelism: a rank's slice of
    #    the cache from global position t0) at tp = 2 x sp = 2's local
    #    shapes, 16/4 heads over the second 2,048 positions of a 4,096-
    #    position cache (t0 = 2048): flash-decode S = 8, Tq = 1, 1,748 to
    #    3,508 committed (the last slot's all on the first slice: it sees
    #    nothing here), and a 128-row flash-prefill chunk from 2,008 (its
    #    first 40 rows see nothing here) beside one from 3,000; then the
    #    tree mode in the state mode, a [2, 1, 1] verify (Tq = 7 over its
    #    7 nodes' key positions and bit rows) at S = 3: slot 0's nodes
    #    from 2,045 (its root's row sees nothing here), slot 1's from
    #    3,048, slot 2's from 1,748 (all on the first slice)
    sp_rows = {}
    Hs, Hkvs, Ts, t0s = 16, 4, 2048, 2048
    scale = 1.0 / D ** 0.5
    from powerserve_tpu_torch.ops.flash_decode import pack_intra

    parents = [-1, 0, 0, 1, 2, 3, 4]  # TreeTemplate [2, 1, 1]
    anc = torch.zeros(7, 7, dtype=torch.bool, device=dev)
    for i_ in range(7):
        j_ = i_
        while j_ >= 0:  # ancestors-or-self
            anc[i_, j_] = True
            j_ = parents[j_]
    for kind, S, Tq, first in (
            ("decode", 8, 1, [2100 + 201 * s_ for s_ in range(7)] + [1748]),
            ("prefill", 2, 128, [2008, 3000]),
            ("decode_tree", 3, 7, [t0s - 3, t0s + 1000, 1748])):
        q = randn(S, Tq, Hs, D)
        kq, ks, vq, vs = cache(S, Hkvs, Ts, D)
        mask = (t0s + torch.arange(Ts, device=dev)[None, :]
                < torch.tensor(first, device=dev)[:, None])
        if kind.startswith("decode"):
            pos = (torch.tensor(first, dtype=torch.int32, device=dev)[:, None]
                   + torch.arange(Tq, dtype=torch.int32, device=dev))
            args = (q, kq, ks, vq, vs, mask, pos, scale)
            bits = pack_intra(anc) if kind == "decode_tree" else None

            def fn(args=args, bits=bits):
                return flash_decode_cuda(*args, bits=bits, state=True,
                                         t0=t0s)

            def ref_fn(args=args, bits=bits):
                return flash_decode_quant_reference(*args, bits=bits,
                                                    state=True, t0=t0s)

            vis = decode_visibility(mask, pos - t0s, Tq, bits)
            extra = nbytes(mask, pos) + (0 if bits is None
                                         else nbytes(bits))
        else:
            start = torch.tensor(first, dtype=torch.int32, device=dev)
            args = (q, kq, ks, vq, vs, mask, start, scale)

            def fn(args=args):
                return flash_prefill_cuda(*args, state=True, t0=t0s)

            def ref_fn(args=args):
                return flash_prefill_quant_reference(*args, state=True,
                                                     t0=t0s)

            vis = prefill_visibility(mask, start - t0s, Tq)[..., :Ts]
            extra = nbytes(mask, start)
        o, m_, l_ = fn()
        ro, rm, rl = ref_fn()
        seen = vis.any(dim=-1)[:, None, :].expand(S, Hs, Tq).reshape(S, -1)
        if not (seen.any() and (~seen).any()):
            raise AssertionError(f"state {kind}: the case lost its rows "
                                 f"that see nothing")
        if not ((m_[~seen] == -1e30).all() and (l_[~seen] == 0).all()
                and (o[~seen] == 0).all()):
            raise AssertionError(f"state {kind}: a row that sees nothing "
                                 f"is not m = -1e30, l = 0, o = 0")
        check(f"flash_{kind} state m", m_[seen], rm[seen], 1e-6)
        check(f"flash_{kind} state l", l_[seen], rl[seen], 1e-4)
        err = flips_check(f"flash_{kind} state o", o[seen], ro[seen], vs)
        if not all(torch.equal(a, b) for a, b in zip((o, m_, l_), fn())):
            raise AssertionError(f"state {kind}: two runs gave different "
                                 f"bits")
        b, by = attn_bound(q, vis, Hkvs, extra + nbytes(m_, l_))
        sp_rows[kind] = dict(
            S=S, Tq=Tq, H=Hs, Hkv=Hkvs, T=Ts, t0=t0s, first=first,
            rows_seeing_nothing=int((~seen).sum()), max_abs_err=err,
            ms=timer(fn), plain_ms=timer(ref_fn, reps=5), bound_ms=b,
            bound_by=by, visible_positions=int(vis.sum()),
            sdpa_bf16_dequantized_ms=sdpa_ms(
                q, kq, ks, vq, vs, vis | ~vis.any(dim=-1, keepdim=True)))
        if kind.startswith("decode"):
            sp_rows[kind]["geometry"] = fd_geometry(
                q, Hkvs, Ts, Tq, vis, 0, kind == "decode_tree", True)
        del q, kq, vq, o, ro

    def prefill_row(name, S, Tq, starts, committed, T=T):
        """A timed flash-prefill case at llama-8b's heads over a cache of
        T positions (default 2048), twice bit for bit."""
        q = randn(S, Tq, H, D)
        kq, ks, vq, vs = cache(S, Hkv, T, D)
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.tensor(committed, device=dev)[:, None])
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        args = (q, kq, ks, vq, vs, mask, start, 1.0 / D ** 0.5)
        got = flash_prefill_cuda(*args)
        err = flips_check(f"flash_prefill {name}", got,
                          flash_prefill_quant_reference(*args), vs)
        if not torch.equal(got, flash_prefill_cuda(*args)):
            raise AssertionError(f"flash_prefill {name}: two runs gave "
                                 f"different bits")
        vis = prefill_visibility(mask, start, Tq)[..., :T]
        b, by = attn_bound(q, vis, Hkv, nbytes(mask, start))
        return dict(
            case=name, S=S, Tq=Tq, T=T, D=D, starts=starts,
            committed=committed, max_abs_err=err,
            ms=timer(lambda: flash_prefill_cuda(*args)),
            plain_ms=timer(lambda: flash_prefill_quant_reference(*args),
                           reps=5),
            bound_ms=b, bound_by=by, visible_positions=int(vis.sum()),
            sdpa_bf16_dequantized_ms=sdpa_ms(q, kq, ks, vq, vs, vis))

    def gemm_row(lin, m, k, n):
        """A timed Q4_K prefill GEMM case, twice bit for bit."""
        x = randn(m, k, dtype=torch.bfloat16)
        got = qmatmul_cuda(x, lin)
        err = check(f"qmatmul q4_k {m}x{k}x{n}", got,
                    qmatmul_reference(x, lin), 1e-4)
        if not torch.equal(got, qmatmul_cuda(x, lin)):
            raise AssertionError(f"qmatmul q4_k {m}x{k}x{n}: two runs gave "
                                 f"different bits")
        moved = nbytes(x) + lin.nbytes() + m * n * 4
        b, by = bound_ms(moved, 2.0 * m * n * k)
        ms = timer(lambda: qmatmul_cuda(x, lin))
        return dict(quant="q4_k", m=m, k=k, n=n, max_abs_err=err, ms=ms,
                    plain_ms=timer(lambda: qmatmul_reference(x, lin), reps=5),
                    bound_ms=b, bound_by=by, gb_s=moved / ms / 1e6)

    # -- rows added after the ones above, so those keep their seeds: the
    #    bucket without its long slot (190 committed in place of 1900: what
    #    the walk costs without the one long unit), and the prefill GEMM
    #    at the scheduler's 8 x 128-token chunk (M = 1024, 4096 -> 28672)
    g.manual_seed(1)
    fp_rows.append(prefill_row("bucket_short", 8, 128,
                               [0, 128, -1, 512, 40, 1000, -1, 190],
                               [0, 128, 300, 512, 40, 1000, 0, 190]))
    qmm_rows.append(gemm_row(_rand_qlinear(g, 4096, 28672, "q4_k", dev),
                             1024, 4096, 28672))
    # -- then, with a seed of their own: flash-prefill at `generate`'s
    #    chunked prefill (one slot, the last 128-row chunk of a 2048-token
    #    prompt: 32 blocks, each walking 31 chunks), and the prefill GEMM
    #    at a speculative verify's M = 40 (8 slots, k = 4)
    g.manual_seed(2)
    fp_rows.append(prefill_row("chunk", 1, 128, [1920], [1920]))
    for k, n in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        qmm_rows.append(gemm_row(_rand_qlinear(g, k, n, "q4_k", dev), 40, k,
                                 n))
    # -- then, with a seed of their own: W8 at llama-8b's four layer shapes
    #    (M = 1 and 512), the head (M = 1), and 4096 -> 28672 at a verify's
    #    M = 40 and the scheduler's M = 1024
    g.manual_seed(3)
    for k, n, ms in ((4096, 6144, (1, 512)), (4096, 4096, (1, 512)),
                     (4096, 28672, (1, 512)), (14336, 4096, (1, 512)),
                     (4096, 128256, (1,)), (4096, 28672, (40, 1024))):
        lin8 = _rand_qlinear(g, k, n, "w8", dev)
        for m in ms:
            w8_rows.append(w8_row(lin8, m, k, n))
        del lin8
    # -- then, with a seed of their own: the W8 GEMV at the tile heights
    #    the decode paths give it at 4096 -> 28672 (M = 2, 5: a chain
    #    verify of k + 1 rows, 8: the 8-slot tick, 9: the first height with
    #    a second B tile, 16), beside M = 1's row
    g.manual_seed(7)
    lin8 = _rand_qlinear(g, 4096, 28672, "w8", dev)
    for m in (2, 5, 8, 9, 16):
        w8_rows.append(w8_row(lin8, m, 4096, 28672))
    del lin8
    # -- then, with a seed of their own: flash-decode's tree mode (absent
    #    from trees before it), a [2, 1, 1] token tree (N = 7 nodes at
    #    c + i): DeviceTreeEngine's verify (S = 1, the ancestor rows over
    #    the nodes, T = 2048) and one of its draft levels (Tq = 2 rows
    #    over all 7 nodes, the committed mask), and the scheduler's paged
    #    verify (S = 8 over 560-650 committed positions, pages of 64);
    #    each against its twin (flips_check), twice bit for bit, SDPA with
    #    the same boolean visibility for information; the causal rows
    #    (lower-triangular bits) give today's bits, dense and paged
    #    Two more cases part the cache length's share of the verify's time
    #    from its rows' share: the verify over a 1,024-position cache, and
    #    row 5's one-row decode (the causal rule) over the verify's 2,048
    #    positions and its span. Each tree row records its launch geometry
    #    (splits, token groups, tiles a warp, the clusters the card holds
    #    at once; absent from trees before it) and the twin's walk (end,
    #    tokens a warp)
    tree_rows = []
    if hasattr(fd_mod, "pack_intra"):
        from powerserve_tpu_torch.ops.flash_decode import pack_intra

        g.manual_seed(4)
        N = anc.shape[0]  # the [2, 1, 1] tree's, built for the state rows

        def tree_case(case, S, rows, paged, Tc):
            causal = rows is None
            intra = anc[[0] if causal else rows]
            bits = None if causal else pack_intra(intra)
            Tq = intra.shape[0]
            starts = ([1000] if S == 1
                      else [560 + 13 * s_ for s_ in range(S)])
            mask = (torch.arange(Tc, device=dev)[None, :]
                    < torch.tensor(starts, device=dev)[:, None])
            keys = (torch.tensor(starts, device=dev)[:, None]
                    + torch.arange(Tq if causal else N, device=dev)[None, :]
                    ).to(torch.int32)
            q = randn(S, Tq, H, D)
            extra = nbytes(mask, keys) + (0 if causal else nbytes(bits))
            if paged:
                MP = T // page
                n_alloc = [-(-(c_ + N) // page) for c_ in starts]
                P = sum(n_alloc) + 8
                perm = torch.randperm(P, generator=g, device=dev).to(
                    torch.int32)
                pt = torch.full((S, MP), P, dtype=torch.int32, device=dev)
                used = 0
                for s_, n_ in enumerate(n_alloc):
                    pt[s_, :n_] = perm[used:used + n_]
                    used += n_
                kv4 = cache(P, Hkv, page, D)
                args = (q, *kv4, pt, mask, keys, scale)
                fn = lambda: flash_decode_paged_cuda(*args, bits=bits)  # noqa
                ref_fn = lambda: flash_decode_paged_reference(  # noqa: E731
                    *args, bits=bits)
                dense4 = tuple(gather_pages(t, pt) for t in kv4)
                extra += nbytes(pt)
            else:
                dense4 = cache(S, Hkv, Tc, D)
                args = (q, *dense4, mask, keys, scale)
                fn = lambda: flash_decode_cuda(*args, bits=bits)  # noqa
                ref_fn = lambda: flash_decode_quant_reference(  # noqa: E731
                    *args, bits=bits)
            got = fn()
            err = flips_check(f"flash_decode tree {case}", got, ref_fn(),
                              dense4[3])
            if not torch.equal(got, fn()):
                raise AssertionError(f"flash_decode tree {case}: two runs "
                                     f"gave different bits")
            vis = decode_visibility(mask, keys, Tq, bits)
            b, by = attn_bound(q, vis, Hkv, extra)
            tree_rows.append(dict(
                case=case, S=S, Tq=Tq, keys=keys.shape[1], T=Tc,
                paged=paged, page=page if paged else None,
                committed=starts, max_abs_err=err, ms=timer(fn),
                plain_ms=timer(ref_fn, reps=10), bound_ms=b, bound_by=by,
                sdpa_bf16_dequantized_ms=sdpa_ms(q, *dense4, vis),
                geometry=fd_geometry(q, Hkv, Tc, keys.shape[1], vis,
                                     page if paged else 0, not causal)))

        for case in (("verify", 1, list(range(N)), False, T),
                     ("draft level 1", 1, [1, 2], False, T),
                     ("paged verify", 8, list(range(N)), True, T)):
            tree_case(*case)
        # the causal rows: today's bits, and their time beside today's
        S, Tq = 2, 5
        q = randn(S, Tq, H, D)
        kq, ks, vq, vs = cache(S, Hkv, T, D)
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.tensor([900, 1500], device=dev)[:, None])
        pos = (torch.tensor([900, 1500], device=dev)[:, None]
               + torch.arange(Tq, device=dev)[None, :]).to(torch.int32)
        causal = pack_intra(torch.ones(Tq, Tq, dtype=torch.bool,
                                       device=dev).tril())
        args = (q, kq, ks, vq, vs, mask, pos, scale)
        if not torch.equal(flash_decode_cuda(*args, bits=causal),
                           flash_decode_cuda(*args)):
            raise AssertionError("flash_decode: the causal bit rows differ "
                                 "from the causal rule")
        pt = torch.arange(S * T // 64, dtype=torch.int32,
                          device=dev).reshape(S, -1)
        pools = tuple(t.reshape((S, Hkv, T // 64, 64) + t.shape[3:])
                      .movedim(2, 1).reshape((-1, Hkv, 64) + t.shape[3:])
                      .contiguous() for t in (kq, ks, vq, vs))
        pargs = (q, *pools, pt, mask, pos, scale)
        if not torch.equal(flash_decode_paged_cuda(*pargs, bits=causal),
                           flash_decode_paged_cuda(*pargs)):
            raise AssertionError("flash_decode_paged: the causal bit rows "
                                 "differ from the causal rule")
        tree_rows.append(dict(
            case="causal rows", S=S, Tq=Tq, T=T, same_bits=True,
            ms=timer(lambda: flash_decode_cuda(*args)),
            bits_ms=timer(lambda: flash_decode_cuda(*args, bits=causal)),
            geometry=fd_geometry(q, Hkv, T, Tq,
                                 decode_visibility(mask, pos, Tq))))
        g.manual_seed(8)
        tree_case("verify T=1024", 1, list(range(N)), False, 1024)
        tree_case("decode Tq=1", 1, None, False, T)
        # the clusters of 1 to 8 blocks the card holds at once, at the
        # verify's shared memory (the card's layout of SMs)
        fits = (None if geometry_of is None else {
            n: geometry_of(1, Hkv, H // Hkv, 7, T, D, N, 0, True,
                           splits=n)["max_active_clusters"]
            for n in range(1, 9)})
        emit({"phase": "flash_decode_geometry", "card": card_line(),
              "max_active_clusters_by_size": fits,
              "rows": [dict(case=r_["case"], S=r_["S"], Tq=r_["Tq"],
                            T=r_["T"], ms=r_["ms"], **r_["geometry"])
                       for r_ in tree_rows]
              + [dict(case=case, ms=row["ms"], **row["geometry"])
                 for case, row in (
                     ("state tree (5ts)", sp_rows["decode_tree"]),
                     ("state (5s)", sp_rows["decode"]),
                     ("paged state (6b)", state_row),
                     ("paged (6)", fdp_rows[0]))]})
    # -- then, with a seed of their own: the shapes perplexity and the
    #    activation dumps add (tools/perplexity.py, logits_mode "all"): the
    #    Q4_K lm_head as a prefill GEMM, 4096 -> 128256 (295 MB of packed
    #    weight), at a 32-row chunk and a 490-row one, and flash-prefill
    #    at a 32-row chunk deep into a 490-position corpus (start 448)
    g.manual_seed(5)
    head = _rand_qlinear(g, 4096, 128256, "q4_k", dev)
    for m in (32, 490):
        qmm_rows.append(gemm_row(head, m, 4096, 128256))
    del head
    fp_rows.append(prefill_row("perplexity chunk", 1, 32, [448], [448],
                               T=490))
    # -- last, with a seed of their own: the sampler's draws
    #    (csrc/sample.cu; absent from trees before it)
    g.manual_seed(6)
    sample_rows = sample_kernel_rows(dev, g, timer)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "flush": "read" if read_flush else "write",
          "empty_launch_ms": empty_ms, "qmatmul": qmm_rows,
          "fused_head": head_rows,
          "flash_decode": fd_rows, "flash_prefill": fp_rows,
          "flash_decode_paged": fdp_rows, "qmatmul_grouped": grp_rows,
          "qmatmul_w8": w8_rows, "fused_linear": fl_rows,
          "flash_decode_paged_state": state_row,
          "flash_decode_state": sp_rows["decode"],
          "flash_prefill_state": sp_rows["prefill"],
          "flash_decode_state_tree": sp_rows["decode_tree"],
          "flash_decode_tree": tree_rows, "sample": sample_rows})

    def entry(name, route_src, replaces, row):
        return dict(name=name, route="cuda", source=route_src,
                    replaces=replaces, launches=0,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None)

    qmm_head = next(r for r in qmm_rows if r["quant"] == "q4_k"
                    and r["m"] == 1 and r["n"] == 28672)
    fused_src = "powerserve_tpu_torch/csrc/fused_linear.cu"
    fused_tpu = "powerserve_tpu/ops/fused.py:298"

    def fl(case, m):
        return next(r for r in fl_rows if r["case"] == case and r["m"] == m)

    return [
        entry("qmatmul", "powerserve_tpu_torch/csrc/qmatmul.cu",
              "powerserve_tpu/ops/qmatmul.py:565", qmm_head),
        entry("fused_head", fused_src, fused_tpu,
              next(r for r in head_rows if r["m"] == 1 and not r["argmax"])),
        entry("fused_x", fused_src, fused_tpu, fl("x wo", 1)),
        entry("fused_norm", fused_src, fused_tpu,
              fl("norm(x+attn) gate|up", 8)),
        entry("fused_glu", fused_src, fused_tpu, fl("glu+2 resids down", 8)),
        entry("fused_x_argmax", fused_src, fused_tpu,
              fl("x+argmax factored head V", 5)),
        entry("fused_concat2", fused_src, fused_tpu,
              fl("concat2+bias eagle fc q8_0", 1)),
        entry("flash_decode_paged_state",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:183", state_row),
        entry("flash_decode", "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:115", fd_rows[0]),
        entry("flash_decode_state",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:115", sp_rows["decode"]),
        entry("flash_decode_state_tree",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:115",
              sp_rows["decode_tree"]),
        entry("flash_prefill_state",
              "powerserve_tpu_torch/csrc/flash_prefill.cu",
              "powerserve_tpu/ops/flash_prefill.py:115",
              sp_rows["prefill"]),
        entry("flash_prefill", "powerserve_tpu_torch/csrc/flash_prefill.cu",
              "powerserve_tpu/ops/flash_prefill.py:115", fp_rows[1]),
        entry("flash_decode_paged",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:183", fdp_rows[0]),
        entry("qmatmul_grouped", "powerserve_tpu_torch/csrc/qmatmul.cu",
              "powerserve_tpu/ops/qmatmul.py:792", grp_rows[0]),
        entry("qmatmul_w8", "powerserve_tpu_torch/csrc/qmatmul_w8.cu",
              "powerserve_tpu/ops/qmatmul.py:236", w8_rows[0]),
    ] + ([
        entry("flash_decode_tree", "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:115", tree_rows[0]),
        entry("flash_decode_paged_tree",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:183", tree_rows[2]),
    ] if tree_rows else []) + ([
        # no TPU kernel: JAX draws with jax.random.categorical under jit
        {**entry("sample", "powerserve_tpu_torch/csrc/sample.cu",
                 "powerserve_tpu/sampling/sampler.py:243", sample_rows[0]),
         "library_ms": sample_rows[0]["library_ms"]},
    ] if sample_rows else [])


# the inverse CDF's slack: the kernel's block scan and torch.cumsum add
# the f32 values in other orders, so a categorical draw may differ from
# the twin's only where u * total lies this close to a CDF boundary (the
# f64 CDF at the smaller token)
CDF_SLACK = 1e-3


def sample_kernel_rows(dev: torch.device, g, timer) -> list[dict]:
    """csrc/sample.cu against its twin on the card, 16 calls a case (the
    counters moving on): the categorical draw at [8, V] for llama-8b's
    and qwen2.5's vocabularies (softmax rows at temperature 1 and 0.3,
    top-40 and top-p masked, one-hot, unnormalized), where a token may
    differ only within CDF_SLACK of a CDF boundary and in at most 1% of
    the rows; a chain's acceptance uniforms [8, 4] and a WOR tree
    level's Gumbel noise [16, 128256], bit-equal. Each with its time,
    its twin's, its bound (the distribution read once, the output
    written once, at 3.35 TB/s) and, for the categorical draw,
    torch.multinomial's on the same rows (information). Empty in a tree
    without the kernel."""
    try:
        from powerserve_tpu_torch.ops import sample as sm
    except ImportError:
        return []
    rows = []
    for V in (128256, 152064):
        R = 8
        logits = torch.randn(R, V, generator=g, device=dev) * 3
        dist = torch.softmax(logits, dim=-1)
        dist[1] = torch.softmax(logits[1] / 0.3, dim=-1)
        kth = dist[2].topk(40).values[-1]
        dist[2] = torch.where(dist[2] >= kth, dist[2], 0.0)
        srt = dist[3].sort(descending=True)
        keep = (srt.values.cumsum(0) - srt.values) < 0.9
        dist[3] = torch.zeros_like(dist[3]).scatter(
            0, srt.indices, torch.where(keep, srt.values, 0.0))
        dist[4] = 0.0
        dist[4, V - 7] = 1.0
        dist[5] *= 3.5
        seed = torch.tensor([3, -1, 2 ** 40, 7, 11, 13, 17, 19], device=dev)
        counter = torch.arange(R, device=dev) * 5
        c1, c2 = counter.clone(), counter.clone()
        differ, err = 0, 0.0
        for _ in range(16):
            c0 = c1.clone()
            got = sm.sample_categorical(dist, seed, c1)
            want = sm.categorical_reference(dist, seed, c2)
            if not (dist.gather(1, got[:, None]) > 0).all():
                raise AssertionError("sample: a token without mass")
            u = sm.unit_floats(sm.draw_words(seed, c0,
                                             torch.zeros_like(c0))[:, 0])
            cdf = dist.double().cumsum(dim=-1)
            for r in torch.nonzero(got != want)[:, 0].tolist():
                lo = min(int(got[r]), int(want[r]))
                gap = abs(float(cdf[r, lo]) - float(u[r]) * float(cdf[r, -1]))
                if gap >= CDF_SLACK:
                    raise AssertionError(f"sample: row {r} draws {got[r]} "
                                         f"vs the twin's {want[r]}, "
                                         f"{gap} from the boundary")
                differ += 1
                err = max(err, gap)
        if not torch.equal(c1, c2) or differ > 0.01 * 16 * R:
            raise AssertionError(f"sample: {differ} rows differ, counters "
                                 f"{c1.tolist()} vs {c2.tolist()}")
        b, by = bound_ms(nbytes(dist) + R * 8 + 3 * nbytes(seed), 0.0)
        rows.append(dict(
            mode="categorical", R=R, V=V, max_abs_err=err,
            rows_differing=differ, of_rows=16 * R,
            ms=timer(lambda: sm.sample_categorical(dist, seed, c1)),
            plain_ms=timer(lambda: sm.categorical_reference(dist, seed, c2)),
            library_ms=timer(lambda: torch.multinomial(dist, 1)),
            bound_ms=b, bound_by=by))
    for mode, R, n in (("uniform", 8, 4), ("gumbel", 16, 128256)):
        fn = sm.sample_uniform if mode == "uniform" else sm.sample_gumbel
        ref = sm.uniform_reference if mode == "uniform" else \
            sm.gumbel_reference
        seed = torch.arange(R // 2, device=dev) * 97 + 1
        counter = torch.zeros(R // 2, dtype=torch.int64, device=dev)
        c1, c2 = counter.clone(), counter.clone()
        for _ in range(16):
            a, b_ = fn(seed, c1, R, n), ref(seed, c2, R, n)
            if not torch.equal(a, b_) or not torch.equal(c1, c2):
                raise AssertionError(f"sample ({mode}): not the twin's "
                                     f"bits")
        b, by = bound_ms(R * n * 4 + 3 * nbytes(seed), 0.0)
        rows.append(dict(mode=mode, R=R, V=n, max_abs_err=0.0,
                         ms=timer(lambda: fn(seed, c1, R, n)),
                         plain_ms=timer(lambda: ref(seed, c2, R, n)),
                         library_ms=None, bound_ms=b, bound_by=by))
    return rows


def first_divergence(a: list[int], b: list[int]) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| as a share of ref's range."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.max() - ref.min())).item()


# the kernels a draft of at most 4 layers runs: the fused layer chain and
# the fused head (argmax)
SPEC_NEED = ("fused_head", "fused_x", "fused_norm", "fused_glu", "qmatmul",
             "flash_decode")
# a tree's: the draft levels and the verify attend through the tree mode
TREE_NEED = SPEC_NEED[:-1] + ("flash_decode_tree",)


def phase_cli() -> dict:
    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.core.config import WorkspaceConfig
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                      make_synthetic_gguf)

    result = {"phase": "cli", "logit_tolerance": LOGIT_REL}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, quant in (("tiny", GGMLType.Q8_0),
                              ("tiny-k", GGMLType.Q4_K),
                              ("tiny-moe", GGMLType.Q8_0)):
            ws = make_synthetic_gguf(f"{tmp}/{preset}", preset, quant, seed=0,
                                     seq_len=256)
            argv = ["-d", str(ws), "-p", "The quick brown fox", "-n", "16",
                    "--temperature", "0", "--no-progress"]
            # the MoE model decodes one token at a time: the single-token
            # route through the grouped kernel
            need = ("qmatmul", "fused_head", "flash_decode", "flash_prefill")
            if preset == "tiny-moe":
                need += ("qmatmul_grouped",)
            cuda_lib.reset_launch_counts()
            gpu = run.run_prompt(run.parse_args(argv + ["--device", "cuda"]))
            counts = cuda_lib.launch_counts()
            if not all(counts[k] for k in need):
                raise AssertionError(f"{preset}: a kernel was not launched: "
                                     f"{counts}")
            cpu = run.run_prompt(run.parse_args(argv + ["--device", "cpu"]))
            hp = WorkspaceConfig.load(ws).hyper_params
            eng_gpu, _ = run.build_engine(str(ws / "model"), hp, "cuda")
            eng_cpu, _ = run.build_engine(str(ws / "model"), hp, "cpu")
            # the prompt's last logits, then each generated token fed back
            # alone (a decode step), on the kernels and on the plain path
            gaps = [logit_gap(eng_gpu.prefill(part), eng_cpu.prefill(part))
                    for part in [gpu.prompt_ids] + [[t] for t in gpu.ids]]
            if not max(gaps) <= LOGIT_REL:
                raise AssertionError(f"{preset}: cuda and cpu logits differ "
                                     f"by {max(gaps)} of their range")
            i = first_divergence(gpu.ids, cpu.ids)
            gap = None
            if i >= 0:
                # the cpu logits for the step that chose token i, teacher-
                # forced on the gpu's tokens
                eng_cpu.reset()
                logits = eng_cpu.prefill(gpu.prompt_ids + gpu.ids[:i])
                top2 = logits.topk(2).values
                gap = float(top2[0] - top2[1])
                if not gap < NEAR_TIE:
                    raise AssertionError(
                        f"{preset}: cuda {gpu.ids} vs cpu {cpu.ids} differ "
                        f"at {i} with a top-2 gap of {gap}")
            result[preset] = dict(tokens_cuda=gpu.ids, tokens_cpu=cpu.ids,
                                  first_divergence=i, top2_gap=gap,
                                  logit_gap_max=max(gaps),
                                  logit_gap_steps=len(gaps),
                                  launches=counts)
            if preset == "tiny":
                result[preset]["kv_file"] = cli_kv_file(run, ws, argv, tmp,
                                                        eng_gpu)
            if preset == "tiny-moe":
                continue
            # speculation: chains with a 1-layer self-draft and with a
            # separate draft (the same preset, another seed), the device
            # tree [2, 1, 1] with each, and the host-grown tree with the
            # separate draft, each on cuda and on cpu; greedy tokens must
            # be the plain run's on the same device
            draft = make_synthetic_gguf(f"{tmp}/{preset}-draft", preset,
                                        quant, seed=7, seq_len=256)
            d_arg = ["--draft", str(draft / "model")]
            dtree = ["--spec-engine", "device-tree", "--spec-tree", "2,1,1"]
            # a random EAGLE head at the preset's widths: its dir selects
            # the EAGLE engine (a chain, or the device tree)
            e_arg = ["--draft", str(make_eagle_gguf(
                f"{tmp}/{preset}-eagle", preset, seed=9))]
            e_need = ("fused_concat2",) + SPEC_NEED
            spec = {}
            for label, extra, need_ in (
                    ("self-draft-layers 1", ["--self-draft-layers", "1"],
                     SPEC_NEED),
                    ("draft", d_arg, SPEC_NEED),
                    ("device-tree self-draft-layers 1",
                     dtree + ["--self-draft-layers", "1"], TREE_NEED),
                    ("device-tree draft", dtree + d_arg, TREE_NEED),
                    ("tree draft", ["--spec-engine", "tree"] + d_arg,
                     ("qmatmul", "fused_head", "flash_decode_tree")),
                    ("eagle", e_arg, e_need + ("fused_x_argmax",)),
                    ("device-tree eagle", dtree + e_arg,
                     e_need[:-1] + ("flash_decode_tree",))):
                for dev_name, plain, eng in (("cuda", gpu, eng_gpu),
                                             ("cpu", cpu, eng_cpu)):
                    cuda_lib.reset_launch_counts()
                    r = run.run_prompt(run.parse_args(
                        argv + extra + ["--spec-k", "3", "--device",
                                        dev_name]))
                    spec_counts = cuda_lib.launch_counts()
                    if dev_name == "cuda":
                        missing = [k for k in need_
                                   if not spec_counts[k]]
                        if missing:
                            raise AssertionError(f"{preset} spec {label}: "
                                                 f"did not launch {missing}")
                    spec[f"{label} {dev_name}"] = dict(
                        tokens=r.ids, summary=r.spec.summary(),
                        vs_run_near_tie=agree(
                            f"{preset} spec {label} {dev_name}", r.ids,
                            plain.ids, eng, plain.prompt_ids))
            result[preset]["spec"] = spec
    return result


def cli_kv_file(run, ws, argv: list[str], tmp: str, engine) -> dict:
    """`run --save-kv` on cuda, then `run --load-kv` of that file with
    another prompt: the second run's tokens are generate's over the saved
    stream (the first prompt and its tokens fed back) and the second
    prompt fed whole (near-tie rule), and both runs launch the kernels."""
    from powerserve_tpu_torch.ops import cuda_lib

    path = f"{tmp}/prefix.npz"
    cuda_lib.reset_launch_counts()
    first = run.run_prompt(run.parse_args(
        argv + ["--device", "cuda", "--save-kv", path]))
    second = run.run_prompt(run.parse_args(
        ["-d", str(ws), "-p", "jumps over", "-n", "16", "--temperature", "0",
         "--no-progress", "--device", "cuda", "--load-kv", path]))
    counts = cuda_lib.launch_counts()
    missing = [k for k in ("qmatmul", "fused_head", "flash_decode",
                           "flash_prefill") if not counts[k]]
    if missing:
        raise AssertionError(f"run --save-kv/--load-kv did not launch "
                             f"{missing}")
    import numpy as np

    n = int(np.load(path)["n"])
    stream = first.prompt_ids + first.ids[:-1]
    if n != len(stream):
        raise AssertionError(f"--save-kv wrote {n} tokens, not "
                             f"{len(stream)}")
    from powerserve_tpu_torch.tokenizer import Tokenizer

    stop = Tokenizer.from_model_dir(ws / "model").should_stop
    engine.reset()
    whole = stream + second.prompt_ids
    want = list(engine.generate(whole, 16, stop_fn=stop))
    return dict(prefix_tokens=n, tokens=second.ids, tokens_whole=want,
                near_tie=agree("run --load-kv vs the stream fed whole",
                               second.ids, want, engine, whole))


class Counted:
    """Runs paths with the launch counts zeroed just before each and read
    just after; every kernel in `need` must have launched, none in
    `absent`."""

    def __init__(self):
        self.launches: dict[str, dict] = {}

    def __call__(self, path: str, need: tuple, fn, absent: tuple = ()):
        from powerserve_tpu_torch.ops import cuda_lib

        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = self.launches[path] = cuda_lib.launch_counts()
        missing = [k for k in need if not got[k]]
        extra = [k for k in absent if got[k]]
        if missing or extra:
            raise AssertionError(f"{path} did not launch {missing} or "
                                 f"launched {extra}: {got}")
        return out, seconds


def eager_steps():
    """Every step graph (powerserve_tpu_torch/engine/graphs.py) runs its
    body eagerly: the replayed paths' twin, a Python loop of eager
    forwards."""
    from unittest import mock

    from powerserve_tpu_torch.engine.graphs import StepGraph

    return mock.patch.object(StepGraph, "__call__", StepGraph.eager)


def graph_stats(*owners) -> dict:
    """The step graphs the owners (StepGraphs) captured, the seconds
    their captures took, the bytes their memory pools hold on the card,
    and the replays they ran (a tree before replays were counted: 0)."""
    from powerserve_tpu_torch.engine.graphs import pool_bytes

    captured = [g for o in owners for g in o.graphs.values()
                if g.graph is not None]
    return {"graphs": len(captured),
            "capture_s": sum(g.capture_s for g in captured),
            "pool_mb": sum(pool_bytes(o) for o in owners) / 1e6,
            "replays": sum(getattr(g, "replays", 0) for g in captured)}


def same_cache_bits(label: str, a, b) -> None:
    for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{label}: the replayed path's cache {name} "
                                 f"differs from the eager twin's")


def same_launches(label: str, launches: dict, path: str, twin: str) -> None:
    if launches[path] != launches[twin]:
        raise AssertionError(f"{label}: {path} launched {launches[path]}, "
                             f"its eager twin {launches[twin]}")


def plain_routes() -> dict:
    """The forward's kernel calls (models/llama.py) sent to their plain
    twins, for mock.patch.multiple."""
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_paged_reference, flash_decode_quant_reference)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_quant_reference)
    from powerserve_tpu_torch.ops.fused import fused_linear_reference
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_grouped_reference,
                                                  qmatmul_reference)

    def plain_qmm(x, lin):
        y = qmatmul_reference(x.reshape(-1, x.shape[-1]), lin)
        return y.reshape(*x.shape[:-1], lin.out_features)

    # (a W8 head's twin is its composition on the W8 twin)
    return dict(qmatmul=plain_qmm, qmatmul_grouped=qmatmul_grouped_reference,
                fused_linear=fused_linear_reference,
                flash_decode_quant=flash_decode_quant_reference,
                flash_decode_paged=flash_decode_paged_reference,
                flash_prefill_quant=flash_prefill_quant_reference)


def step_on(routes: dict, fn):
    """fn() with the forward's kernel calls replaced by `routes`."""
    from unittest import mock

    import powerserve_tpu_torch.models.llama as llama

    with (mock.patch.multiple(llama, **routes) if routes
          else contextlib.nullcontext()):
        return fn()


def near_tie_agree(label: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Logits of the kernels against the plain twins' on the card: within
    LOGIT_REL of the range, and the same greedy token per row unless the
    plain top-2 gap is < NEAR_TIE. Returns the gap share."""
    gap = logit_gap(got, ref)
    if not torch.isfinite(got).all() or not gap <= LOGIT_REL:
        raise AssertionError(f"{label}: kernels differ from the plain twins "
                             f"by {gap} of the range")
    got2, ref2 = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    top2 = ref2.topk(2, dim=-1)
    flip = got2.argmax(dim=-1) != top2.indices[:, 0]
    close = (top2.values[:, 0] - top2.values[:, 1]) < NEAR_TIE
    if (flip & ~close).any():
        raise AssertionError(f"{label}: the kernels' greedy token is not the "
                             f"plain path's")
    return gap


def w8_calls_check(fn) -> tuple[float, int]:
    """Run fn with every W8 product of the forward (the projections and
    the lm_head) computed by the kernel and, on the same input, by its
    twin; each within 1e-4 of its largest output (exact int32 block dots,
    f32 sums in another order). Returns (max error share, calls)."""
    from unittest import mock

    import powerserve_tpu_torch.models.llama as llama
    import powerserve_tpu_torch.ops.fused as fused
    from powerserve_tpu_torch.ops.qmatmul import qmatmul, qmatmul_reference

    errs = []

    def both(x, lin):
        y = qmatmul(x, lin)
        if lin.w8:
            x2 = x.reshape(-1, x.shape[-1])
            ref = qmatmul_reference(x2, lin)
            err = (y.reshape(ref.shape) - ref).abs().max().item()
            errs.append(err / max(1.0, ref.abs().max().item()))
        return y

    with mock.patch.object(llama, "qmatmul", both), \
            mock.patch.object(fused, "qmatmul", both):
        fn()
    if not errs or max(errs) > 1e-4:
        raise AssertionError(f"W8 products against their twin: {len(errs)} "
                             f"calls, max error share {max(errs or [0])}")
    return max(errs), len(errs)


def a8_flips(run, n_layers: int) -> dict:
    """The int8 activation codes of every W8 product of run({}) (the
    kernels) against those of run(plain_routes()) (the twins), call by
    call: each product's input is recorded where it enters (the kernel
    route's qmatmul_w8_cuda, the twin's qmatmul_w8_reference) and
    quantized by quantize_activations, the quantize pass's bit-equal
    twin. How many codes differ in each layer (its four products) and in
    the lm_head, and by how much at most."""
    from unittest import mock

    import powerserve_tpu_torch.ops.qmatmul as qm

    def codes(routes: dict) -> list[torch.Tensor]:
        out = []

        def entry(real):
            def record(x, lin):
                out.append(qm.quantize_activations(x.to(torch.bfloat16))[0])
                return real(x, lin)
            return record

        with mock.patch.object(qm, "qmatmul_w8_cuda",
                               entry(qm.qmatmul_w8_cuda)), \
                mock.patch.object(qm, "qmatmul_w8_reference",
                                  entry(qm.qmatmul_w8_reference)):
            run(routes)
        return out

    got, ref = codes({}), codes(plain_routes())
    per = (len(got) - 1) // n_layers
    if len(got) != len(ref) or len(got) != per * n_layers + 1:
        raise AssertionError(f"a8 codes of {len(got)} and {len(ref)} W8 "
                             f"products over {n_layers} layers")
    diff = [(a.int() - b.int()).abs() for a, b in zip(got, ref)]
    flips = [int((d > 0).sum()) for d in diff]
    return dict(codes_per_step=sum(d.numel() for d in diff),
                flipped_by_layer=[sum(flips[i * per:(i + 1) * per])
                                  for i in range(n_layers)],
                flipped_head=flips[-1],
                max_code_diff=max(int(d.max()) for d in diff))


def w8_requantize(model) -> None:
    """Every projection and the lm_head of a GGUF-format model replaced in
    place by its W8 requantization: core/quant.py's requantize_w8 (per
    128 rows, symmetric int8 of the exact dequantized weights) on the
    card."""
    from powerserve_tpu_torch.core.quant import MXU_GROUP
    from powerserve_tpu_torch.ops.qmatmul import QLinear, dequant

    def w8(lin: QLinear) -> QLinear:
        w = dequant(lin)
        k, n = w.shape
        wg = w.reshape(k // MXU_GROUP, MXU_GROUP, n)
        scales = wg.abs().amax(dim=1) / 127.0
        inv = torch.where(scales > 0,
                          1.0 / torch.where(scales == 0, 1.0, scales), 0.0)
        q8 = torch.clamp(torch.round(wg * inv[:, None, :]), -127, 127)
        return QLinear(q8.to(torch.int8).reshape(k, n), scales, None,
                       packed=False, unsigned=False, in_features=k,
                       out_features=n, scale_group=MXU_GROUP)

    for layer in model.layers:
        for name in ("wqkv", "wo", "wgu", "w_down"):
            setattr(layer, name, w8(getattr(layer, name)))
    model.lm_head = w8(model.lm_head)


def phase_full_width(dev: torch.device, cfg, model, phase: str,
                     hold_end_to_end: bool = True) -> tuple[dict, dict]:
    """llama-8b's run paths on `model` (GGUF-format or W8). The prefill
    and one decode step are held against the twins within LOGIT_REL if
    `hold_end_to_end`, else their gaps are only reported."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.engine.loops import (decode_scan,
                                                   decode_scan_eager,
                                                   prefill_step)
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_quant_reference)

    torch.cuda.reset_peak_memory_stats(dev)
    llm = cfg.llm
    n_prompt, n_decode, max_seq = 512, 64, 2048
    g = torch.Generator(device="cpu")
    g.manual_seed(1)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    counted = Counted()
    # W8: every projection and the lm_head through the W8 kernel, so the
    # GGUF qmatmul and the fused head never launch
    w8 = model.lm_head.w8
    mm = ("qmatmul_w8",) if w8 else ("qmatmul", "fused_head")
    absent = ("qmatmul", "fused_head") if w8 else ()

    all3 = mm + ("flash_decode",)
    kv = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                        llm.head_size, dev)
    # 512 query rows attend through the flash-prefill kernel
    logits, prefill_s = counted("prefill_step", mm + ("flash_prefill",),
                                lambda: prefill_step(
                                    model, prompt[None].to(dev),
                                    torch.arange(n_prompt, device=dev)[None],
                                    kv), absent)
    if logits.shape != (1, llm.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or misshapen")
    first = logits.argmax(dim=-1)

    # one decode step on the kernels, and the same step with the forward's
    # kernel calls sent to their plain twins, on copies of the cache
    def step(routes: dict) -> torch.Tensor:
        c = kv.clone()
        return step_on(routes, lambda: model(
            c, first[:, None], kv.pos.long()[:, None], logits_mode="last")[0])

    def prefill_into_fresh_cache():
        c = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                           llm.head_size, dev)
        return prefill_step(model, prompt[None].to(dev),
                            torch.arange(n_prompt, device=dev)[None], c)

    checks: dict = {"held_end_to_end": hold_end_to_end}
    if w8:
        # every W8 product of the prefill (M = 512) and of the decode step
        # (M = 1) on the kernel against the W8 twin on the same input
        (checks["w8_prefill_calls_max_err"],
         checks["w8_prefill_calls"]) = w8_calls_check(prefill_into_fresh_cache)
        checks["w8_step_calls_max_err"], checks["w8_step_calls"] = \
            w8_calls_check(lambda: step({}))
        checks["a8_codes"] = a8_flips(step, llm.n_layers)
        # a W8 prefill reads nothing back to the host (the decode step is
        # held so below)
        c = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                           llm.head_size, dev)
        toks = prompt[None].to(dev)
        pos = torch.arange(n_prompt, device=dev)[None]
        without_sync(f"{phase} prefill",
                     lambda: prefill_step(model, toks, pos, c))
        checks["prefill_sync_free"] = True
        del c
    # the same 512-token prefill with flash_prefill_quant sent to its twin
    # on the card, into a fresh cache; one decode step on the kernels
    # against the plain twins
    cuda_lib.reset_launch_counts()
    logits_twin = step_on(
        dict(flash_prefill_quant=flash_prefill_quant_reference),
        prefill_into_fresh_cache)
    if cuda_lib.launch_counts()["flash_prefill"]:
        raise AssertionError("the twin prefill launched the kernel")
    # the decode step reads nothing back to the host: fixed-shape KV writes
    sync_free = without_sync(f"{phase} decode step", lambda: step({}))
    pairs = {"prefill_logit_gap": (logits, logits_twin),
             "decode_step_logit_gap": (sync_free, step(plain_routes()))}
    checks["decode_step_sync_free"] = True
    for key, (got, ref) in pairs.items():
        checks[key] = (near_tie_agree(f"{phase} {key}", got, ref)
                       if hold_end_to_end else logit_gap(got, ref))
    del logits_twin, pairs

    # decode_scan replays one step graph per token (its first call: one
    # step eager, then the capture); its eager twin runs on a copy of the
    # cache. Twice each: the second replayed call, all replays, is held
    # under set_sync_debug_mode("error") (the capture, which
    # synchronizes, happened in the first)
    twin_kv = kv.clone()
    scan, twin, secs = [], [], {}
    for i, (label, fn, c, out) in enumerate((
            ("decode_scan", decode_scan, kv, scan),
            ("decode_scan_eager", decode_scan_eager, twin_kv, twin),
            ("decode_scan replayed", decode_scan, kv, scan),
            ("decode_scan_eager again", decode_scan_eager, twin_kv,
             twin))):
        tok = first if not out else out[-1][:, -1]
        call = lambda: fn(model, tok, c, n_decode)  # noqa: E731
        if i == 2:
            call = lambda: without_sync(  # noqa: E731
                f"{phase} replayed decode_scan", lambda: fn(model, tok, c,
                                                            n_decode))
        toks, secs[label] = counted(label, all3, call, absent)
        out.append(toks)
    scan_ids, twin_ids = (torch.cat(t, dim=1)[0].tolist()
                          for t in (scan, twin))
    if scan_ids != twin_ids:
        raise AssertionError(f"{phase}: replayed decode_scan {scan_ids} != "
                             f"its eager twin's {twin_ids}")
    same_cache_bits(f"{phase} decode_scan", kv, twin_kv)
    same_launches(phase, counted.launches, "decode_scan",
                  "decode_scan_eager")
    if not all(0 <= t < llm.vocab_size for t in scan_ids):
        raise AssertionError(f"decode_scan tokens out of range: {scan_ids}")
    scan_graphs = graph_stats(graphs_of(kv))
    scan_ids = scan_ids[:n_decode]
    del kv, twin_kv

    hp = HyperParams(max_slots=1, max_seq_len=max_seq, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    # generate, replayed and with every step eager (the twin); each twice
    # on one engine, the second call steady (its steps all replays)
    gen = {}
    for label in ("generate", "generate_eager"):
        engine = InferenceEngine(model, cfg, hp, device=dev)
        gen[label] = []
        with (eager_steps() if label == "generate_eager"
              else contextlib.nullcontext()):
            for again in (False, True):
                engine.reset()
                stats = GenerationStats()
                ids, _ = counted(label + " again" * again,
                                 all3 + ("flash_prefill",),
                                 lambda: list(engine.generate(
                                     prompt.tolist() + [int(first)],
                                     n_decode, stats=stats)), absent)
                gen[label].append((ids, stats))
        if label == "generate":
            engine_graphs = graph_stats(engine.graphs)
        del engine
    gen_ids, stats = gen["generate"][0]
    if {tuple(ids) for runs in gen.values() for ids, _ in runs} != \
            {tuple(gen_ids)}:
        raise AssertionError(f"{phase}: replayed generate {gen_ids} != its "
                             f"eager twin's or its second call's: {gen}")
    same_launches(phase, counted.launches, "generate", "generate_eager")
    if scan_ids != gen_ids:
        raise AssertionError(f"decode_scan (argmax head) {scan_ids} != "
                             f"generate (logits head) {gen_ids}")
    return ({"phase": phase, "layers": llm.n_layers, "vocab": llm.vocab_size,
             "prefill_tokens": n_prompt,
             "prefill_tok_s": n_prompt / prefill_s, **checks,
             "decode_tokens": n_decode,
             "decode_tok_s": n_decode / secs["decode_scan"],
             "decode_replayed_tok_s": n_decode / secs["decode_scan replayed"],
             "decode_eager_tok_s": n_decode / secs["decode_scan_eager"],
             "decode_eager_again_tok_s":
                 n_decode / secs["decode_scan_eager again"],
             "decode_scan_graphs": scan_graphs,
             "replayed_decode_scan_sync_free": True,
             "generate_prefill_tok_s": stats.prefill_speed,
             "generate_decode_tok_s": stats.decode_speed,
             "generate_again_decode_tok_s":
                 gen["generate"][1][1].decode_speed,
             "generate_eager_decode_tok_s":
                 gen["generate_eager"][0][1].decode_speed,
             "generate_eager_again_decode_tok_s":
                 gen["generate_eager"][1][1].decode_speed,
             "generate_graphs": engine_graphs,
             "tokens_equal": True, "replay_equals_eager": True,
             "launches": counted.launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "card": card_line()}, counted.launches["generate"])


def without_sync(label: str, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any host read
    of device memory or other synchronization raises, and fails the
    phase."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise AssertionError(f"{label} synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def moe_ffn_without_sync(label: str, layer, h: torch.Tensor,
                         k: int) -> tuple:
    """One MoE FFN under torch.cuda.set_sync_debug_mode("error"): a host
    read of the routed ids raises. Returns its (route, block_m)."""
    from powerserve_tpu_torch.models.llama import moe_route

    out = without_sync(f"{label}: the MoE FFN", lambda: layer.moe_ffn(h, k))
    if out.shape != (h.shape[0], h.shape[1]) or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: MoE FFN out {tuple(out.shape)}")
    return moe_route(h.shape[0])


def phase_moe_full_width(dev: torch.device) -> tuple[dict, dict, tuple]:
    """mixtral-lite and qwen3moe-lite Q4_K, random weights, through every
    MoE route. Returns (result, launches of mixtral-lite's generate,
    (cfg, model) of mixtral-lite for the serving phase)."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.engine.loops import (decode_scan,
                                                   decode_scan_eager,
                                                   prefill_step)
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.llama import moe_route
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    counted = Counted()
    result: dict = {"phase": "moe_full_width", "card": card_line()}
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    routes: dict[str, list] = {}

    def decode_batch(model, llm, S, ctx):
        """A cache with S slots prefilled with `ctx` tokens each (one
        forward, S * ctx rows: the grouped route), and the next tokens."""
        kv = KVCache.create(llm.n_layers, S, 4 * ctx, llm.n_kv_heads,
                            llm.head_size, dev)
        toks = torch.randint(3, llm.vocab_size, (S, ctx + 1), generator=g)
        pos = torch.arange(ctx).expand(S, ctx).contiguous()
        model(kv, toks[:, :ctx].to(dev), pos.to(dev), logits_mode="none")
        return kv, toks[:, ctx:].to(dev)

    def twin_step(label, model, kv, nxt, path, need):
        """One decode step on the kernels (counted) and through the plain
        twins, on copies of the cache."""
        def run(r):
            c = kv.clone()
            return step_on(r, lambda: model(c, nxt, kv.pos.long()[:, None],
                                            logits_mode="last"))
        got, _ = counted(path, need, lambda: run({}))
        return near_tie_agree(label, got, run(plain_routes()))

    def sync_free(label, model, llm, rows_list):
        layer = model.layers[0]
        out = []
        for rows in rows_list:
            h = torch.randn(rows, llm.dim, generator=g).to(dev, torch.bfloat16)
            out.append(moe_ffn_without_sync(f"{label} {rows} rows", layer, h,
                                            llm.n_experts_used))
        return out

    # -- mixtral-lite: 8 experts of width 3584, top-2, 32 layers
    t0 = time.perf_counter()
    cfg, model = make_device_params("mixtral-lite", "q4_k", seed=0,
                                    device=dev)
    torch.cuda.synchronize()
    llm = cfg.llm
    result["mixtral-lite"] = mx = {"build_s": time.perf_counter() - t0,
                                   "layers": llm.n_layers,
                                   "experts": llm.n_experts,
                                   "top_k": llm.n_experts_used}
    torch.cuda.reset_peak_memory_stats(dev)
    n_prompt, n_new = 512, 64
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    hp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    # the grouped prefill (512 rows, block_m 128), then one token at a
    # time (the single-token route), replayed; then its eager twin
    gen = {}
    for path in ("mixtral-lite generate", "mixtral-lite generate_eager"):
        engine = InferenceEngine(model, cfg, hp, device=dev)
        gen[path] = []
        with (eager_steps() if path.endswith("eager")
              else contextlib.nullcontext()):
            for again in (False, True):  # the second call steady
                engine.reset()
                stats = GenerationStats()
                ids, gen_s = counted(
                    path + " again" * again,
                    ("qmatmul", "qmatmul_grouped", "fused_head",
                     "flash_prefill", "flash_decode"),
                    lambda: list(engine.generate(prompt.tolist(), n_new,
                                                 stats=stats)))
                if len(ids) != n_new or not all(0 <= t < llm.vocab_size
                                                for t in ids):
                    raise AssertionError(f"{path} gave {ids}")
                gen[path].append((ids, stats, gen_s,
                                  graph_stats(engine.graphs)))
        del engine
    ids, stats, gen_s, engine_graphs = gen["mixtral-lite generate"][0]
    if {tuple(r[0]) for runs in gen.values() for r in runs} != {tuple(ids)}:
        raise AssertionError(f"mixtral-lite: replayed generate {ids} != its "
                             f"eager twin's or its second call's")
    same_launches("mixtral-lite", counted.launches, "mixtral-lite generate",
                  "mixtral-lite generate_eager")
    mx.update(routes_generate=[moe_route(n_prompt), moe_route(1)],
              generate_prefill_tok_s=stats.prefill_speed,
              generate_decode_tok_s=stats.decode_speed,
              generate_again_decode_tok_s=gen[
                  "mixtral-lite generate"][1][1].decode_speed,
              generate_eager_decode_tok_s=gen[
                  "mixtral-lite generate_eager"][0][1].decode_speed,
              generate_eager_again_decode_tok_s=gen[
                  "mixtral-lite generate_eager"][1][1].decode_speed,
              generate_s=gen_s, generate_graphs=engine_graphs,
              replay_equals_eager=True,
              tokens=ids[:16], peak_mem_gb=torch.cuda.max_memory_allocated(
                  dev) / 1e9)
    # decode_scan (argmax head, the single-token route) replayed, and
    # decode_scan_eager on a copy of the same prefilled cache
    kv = KVCache.create(llm.n_layers, 1, 2048, llm.n_kv_heads,
                        llm.head_size, dev)
    first = prefill_step(model, prompt[None].to(dev),
                         torch.arange(n_prompt, device=dev)[None],
                         kv).argmax(dim=-1)
    twin_kv = kv.clone()
    need = ("qmatmul", "qmatmul_grouped", "fused_head", "flash_decode")
    scan, scan_s = counted("mixtral-lite decode_scan", need,
                           lambda: decode_scan(model, first, kv, n_new))
    twin, twin_s = counted("mixtral-lite decode_scan_eager", need,
                           lambda: decode_scan_eager(model, first, twin_kv,
                                                     n_new))
    if not torch.equal(scan, twin):
        raise AssertionError(f"mixtral-lite: replayed decode_scan "
                             f"{scan.tolist()} != its eager twin's "
                             f"{twin.tolist()}")
    same_cache_bits("mixtral-lite decode_scan", kv, twin_kv)
    same_launches("mixtral-lite", counted.launches,
                  "mixtral-lite decode_scan", "mixtral-lite decode_scan_eager")
    mx.update(decode_tok_s=n_new / scan_s, decode_eager_tok_s=n_new / twin_s,
              decode_scan_graphs=graph_stats(graphs_of(kv)))
    del kv, twin_kv
    # S = 8 decode: 16 assignments over 8 experts, grouped at block_m 16
    kv, nxt = decode_batch(model, llm, 8, 64)
    mx["decode_step_route"] = moe_route(8)
    mx["decode_step_logit_gap"] = twin_step(
        "mixtral-lite S=8 decode step", model, kv, nxt,
        "mixtral-lite decode step",
        ("qmatmul", "qmatmul_grouped", "flash_decode", "fused_head"))
    del kv
    routes["mixtral-lite"] = sync_free("mixtral-lite", model, llm,
                                       (1, 8, 512))
    mixtral = (cfg, model)
    mixtral_launches = counted.launches["mixtral-lite generate"]

    # -- qwen3moe-lite: 128 experts of width 768, top-8, 4 layers
    cfg_q, model_q = make_device_params("qwen3moe-lite", "q4_k", seed=0,
                                        device=dev)
    llm_q = cfg_q.llm
    qw = result["qwen3moe-lite"] = {"layers": llm_q.n_layers,
                                    "experts": llm_q.n_experts,
                                    "top_k": llm_q.n_experts_used}
    kv, nxt = decode_batch(model_q, llm_q, 8, 64)
    qw["decode_step_route"] = moe_route(8)
    qw["decode_step_logit_gap"] = twin_step(
        "qwen3moe-lite S=8 decode step", model_q, kv, nxt,
        "qwen3moe-lite decode step",
        ("qmatmul", "qmatmul_grouped", "flash_decode", "fused_head"))
    del kv

    def prefill(routes_):
        kv_ = KVCache.create(llm_q.n_layers, 1, 2048, llm_q.n_kv_heads,
                             llm_q.head_size, dev)
        toks = torch.arange(n_prompt, device=dev)[None] * 7 % llm_q.vocab_size
        pos = torch.arange(n_prompt, device=dev)[None]
        return step_on(routes_, lambda: model_q(kv_, toks, pos,
                                                logits_mode="last"))

    got, prefill_s = counted("qwen3moe-lite prefill",
                             ("qmatmul", "qmatmul_grouped", "flash_prefill",
                              "fused_head"), lambda: prefill({}))
    qw.update(prefill_route=moe_route(n_prompt),
              prefill_tok_s=n_prompt / prefill_s,
              prefill_logit_gap=near_tie_agree("qwen3moe-lite prefill", got,
                                               prefill(plain_routes())))
    routes["qwen3moe-lite"] = sync_free("qwen3moe-lite", model_q, llm_q,
                                        (8, 512))
    del model_q
    seen = {tuple(r) for rs in routes.values() for r in rs}
    if seen != {("single", 1), ("grouped", 16), ("grouped", 128)}:
        raise AssertionError(f"MoE routes driven: {seen}")
    result.update(sync_free_routes=routes, launches=counted.launches)
    return result, mixtral_launches, mixtral


# -- the serving path -------------------------------------------------------


class ServeRecorder:
    """While active: every request submitted to a BatchScheduler keeps its
    prompt ids (as submitted) and the ids its sink received, and every
    error the scheduler logs (a failed step ends its requests with
    "error") is kept, so a kernel failure cannot pass as a short answer."""

    def __init__(self):
        self.requests: list[tuple[list[int], list[int], object]] = []
        self.errors: list[str] = []
        self._lock = threading.Lock()

    def __enter__(self):
        from unittest import mock

        from powerserve_tpu_torch.engine.scheduler import BatchScheduler

        original = BatchScheduler.submit
        rec = self

        def submit(sched, req):
            ids: list[int] = []
            inner = req.sink

            def sink(t):
                if t is not None:
                    ids.append(t)
                inner(t)

            req.sink = sink
            with rec._lock:
                rec.requests.append((list(req.prompt_ids), ids, req))
            return original(sched, req)

        class Errors(logging.Handler):
            def emit(self, record):
                rec.errors.append(record.getMessage())

        self._handler = Errors(level=logging.ERROR)
        self._log = logging.getLogger("powerserve_tpu_torch.scheduler")
        self._log.addHandler(self._handler)
        self._patch = mock.patch.object(BatchScheduler, "submit", submit)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        self._log.removeHandler(self._handler)
        return False

    def check(self, label: str) -> None:
        bad = [r.id for _, _, r in self.requests
               if r.finish_reason == "error"]
        if bad or self.errors:
            raise AssertionError(f"{label}: requests {bad} ended in error; "
                                 f"scheduler errors: {self.errors}")

    def tokens(self) -> dict[tuple, list[int]]:
        return {tuple(p): ids for p, ids, _ in self.requests}


def http_call(port: int, method: str, path: str, body: dict | None = None,
              timeout: float = 900) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def sse_text(data: bytes, chat: bool) -> tuple[str, str]:
    """(concatenated deltas, finish reason) of an SSE stream."""
    text, finish = "", None
    for line in data.decode().splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        ch = json.loads(line[6:])["choices"][0]
        text += (ch.get("delta", {}).get("content", "") if chat
                 else ch.get("text", ""))
        finish = ch.get("finish_reason") or finish
    return text, finish


def metrics_of(port: int) -> dict[str, float]:
    status, data = http_call(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {}
    for line in data.decode().splitlines():
        if line:
            key, val = line.rsplit(" ", 1)
            out[key.split("{")[0].removeprefix("powerserve_")] = float(val)
    return out


def concurrently(calls: list) -> list:
    """Run the zero-argument calls in threads at once; their results."""
    out = [None] * len(calls)
    errs = []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed or hung: {errs}")
    return out


def serving(ctx):
    """An HTTP server for ctx on an ephemeral port, in a thread."""
    from powerserve_tpu_torch.serving.server import make_server

    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def agree(label: str, got: list[int], want: list[int], engine,
          prompt: list[int]) -> float | None:
    """got equals want, or first differs where the reference engine's
    teacher-forced top-2 logit gap is < NEAR_TIE; returns that gap."""
    i = first_divergence(got, want)
    if i < 0:
        return None
    engine.reset()
    top2 = engine.prefill(prompt + want[:i]).float().topk(2).values
    gap = float(top2[0] - top2[1])
    if not gap < NEAR_TIE:
        raise AssertionError(f"{label}: {got} vs {want} differ at {i} with "
                             f"a top-2 gap of {gap}")
    return gap


SERVE_PROMPTS = ["ab", "cde", "xy z", "hello"]
SERVE_CHAT = [{"role": "user", "content": "hi"}]


def serve_run(ws, hp, device: str, model: str = "model",
              ctx=None, same_chats: bool = True) -> dict:
    """Serve the workspace on `device` over HTTP: four concurrent greedy
    completions, a streamed and a plain chat completion, all at once, to
    the model name `model`. The scheduler admits nothing until all six
    are queued (or 10 s passed), so they contend for the slots and the
    pool the same way on every run: otherwise the first requests may run
    alone, and a small pool preempts or not by thread timing; from that
    first admission on it admits as it does (the two requests past the
    four slots used to wait out the 10 s). ctx: serve
    this ServerContext (left open) in place of a new one on ws; over a
    rank group, each rank's launches come back as rank_launches.
    same_chats False: the streamed and the plain chat (the same prompt)
    may part at a near tie, as they may when dp blocks of ranks compute
    them in other batches; the caller holds each request's tokens
    (all_tokens) against a reference."""
    from unittest import mock

    from powerserve_tpu_torch.engine.scheduler import BatchScheduler
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    admit = BatchScheduler._admit
    deadline = time.monotonic() + 10.0
    released = []  # the first admission happened: admit as usual from then

    def admit_all_at_once(sched):
        if released or sched.pending.qsize() >= 6 or \
                time.monotonic() > deadline:
            released.append(True)
            admit(sched)

    own = ctx is None
    if own:
        ctx = ServerContext(ws, "model", hp, device)
    server = serving(ctx)
    port = server.server_address[1]
    try:
        calls = [lambda p=p: http_call(port, "POST", "/v1/completions", {
            "model": model, "prompt": p, "max_tokens": 12,
            "temperature": 0}) for p in SERVE_PROMPTS]
        calls += [lambda st=st: http_call(port, "POST", "/v1/chat/completions",
                                          {"model": model,
                                           "messages": SERVE_CHAT,
                                           "max_tokens": 16,
                                           "temperature": 0, "stream": st})
                  for st in (True, False)]
        with ServeRecorder() as rec, mock.patch.object(
                BatchScheduler, "_admit", admit_all_at_once):
            cuda_lib.reset_launch_counts()
            if ctx.ranks is not None:
                ctx.ranks.launch_counts(reset=True)
            deadline = time.monotonic() + 10.0
            replies = concurrently(calls)
            if device == "cuda":
                torch.cuda.synchronize()
            launches = cuda_lib.launch_counts()
            rank_launches = (None if ctx.ranks is None
                             else ctx.ranks.launch_counts())
        rec.check(f"serve {device}")
        for status, data in replies:
            if status != 200:
                raise AssertionError(f"serve {device}: {status} {data[:200]}")
        texts = [json.loads(d)["choices"][0]["text"] for _, d in replies[:4]]
        streamed, finish = sse_text(replies[4][1], chat=True)
        plain = json.loads(replies[5][1])["choices"][0]
        if same_chats and (streamed != plain["message"]["content"]
                           or finish != plain["finish_reason"]):
            raise AssertionError(f"serve {device}: SSE deltas {streamed!r} "
                                 f"({finish}) != {plain!r}")
        return dict(tokens=rec.tokens(), texts=texts, chat_text=streamed,
                    all_tokens=[(tuple(p), ids) for p, ids, _ in
                                rec.requests],
                    launches=launches, rank_launches=rank_launches,
                    metrics=metrics_of(port))
    finally:
        server.shutdown()
        server.server_close()
        if own:
            ctx.close()


def phase_serve(devices=("cuda", "cpu")) -> dict:
    """The port's HTTP server on tiny Q8_0, tiny-k Q4_K and tiny-moe Q8_0
    workspaces, on each device, with the dense cache and with a paged pool
    small enough to preempt (10 pages of 8 tokens: the chat template alone
    is 55 tokens, 4 completions and 2 chats need ~30 pages at once)."""
    from powerserve_tpu_torch.core.config import HyperParams, WorkspaceConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    need = {"dense": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode"),
            "paged": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode_paged")}
    result: dict = {"phase": "serve"}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, quant in (("tiny", GGMLType.Q8_0),
                              ("tiny-k", GGMLType.Q4_K),
                              ("tiny-moe", GGMLType.Q8_0)):
            ws = make_synthetic_gguf(f"{tmp}/{preset}", preset, quant, seed=0,
                                     seq_len=256)
            engines = {}
            for device in devices:
                cfg, model = load_gguf_model(ws / "model", device=device)
                hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=256)
                hp.sampler.temperature = 0.0
                tok = Tokenizer.from_model_dir(ws / "model")
                engines[device] = (InferenceEngine(model, cfg, hp,
                                                   eos_id=tok.eos_id,
                                                   device=device), tok)
            runs, out = {}, {}
            for cache, pages in (("dense", 0), ("paged", 10)):
                for device in devices:
                    hp = WorkspaceConfig.load(ws).hyper_params
                    hp.max_slots, hp.paged_pages, hp.page_size = 4, pages, 8
                    run = runs[cache, device] = serve_run(ws, hp, device)
                    if (cache, device) == ("dense", "cuda"):
                        SERVED[f"serve_{preset}"] = run["tokens"]
                    label = f"{preset} {cache} {device}"
                    if device == "cuda":
                        missing = [k for k in need[cache]
                                   if not run["launches"][k]]
                        if missing:
                            raise AssertionError(f"{label}: did not launch "
                                                 f"{missing}")
                    if cache == "paged" and not \
                            run["metrics"]["paged_preemptions_total"] > 0:
                        raise AssertionError(f"{label}: no preemption")
                    if preset != "tiny-moe":
                        # "model+self:1": chain speculation from a 1-layer
                        # self-draft, each request's tokens the plain run's
                        spec = serve_run(ws, hp, device, "model+self:1")
                        want = run["tokens"]
                        spec_need = SPEC_NEED + (
                            ("flash_decode_paged_state",) if cache == "paged"
                            else ())
                        if device == "cuda" and not all(
                                spec["launches"][k] for k in spec_need):
                            raise AssertionError(
                                f"{label} spec: did not launch {spec_need}: "
                                f"{spec['launches']}")
                        if cache == "paged" and not \
                                spec["metrics"]["paged_preemptions_total"] > 0:
                            raise AssertionError(f"{label} spec: no "
                                                 f"preemption")
                        out[f"spec_{cache}_{device}"] = dict(
                            texts=spec["texts"], launches=spec["launches"],
                            accept_rate=spec["metrics"].get(
                                "spec_accept_rate"),
                            vs_plain_near_ties=[
                                g for g in (
                                    agree(f"{label} spec vs plain", ids,
                                          want[prompt], engines[device][0],
                                          list(prompt))
                                    for prompt, ids in spec["tokens"].items())
                                if g is not None])
                    # each request against a lone generate on its device
                    engine, tok = engines[device]
                    gaps = []
                    for prompt, ids in run["tokens"].items():
                        engine.reset()
                        want = list(engine.generate(
                            list(prompt), len(ids), stop_fn=tok.should_stop))
                        gaps.append(agree(f"{label} vs generate", ids, want,
                                          engine, list(prompt)))
                    out[f"{cache}_{device}"] = dict(
                        texts=run["texts"], chat=run["chat_text"],
                        launches=run["launches"],
                        preemptions=run["metrics"].get(
                            "paged_preemptions_total"),
                        vs_generate_near_ties=[x for x in gaps
                                               if x is not None])
                # the paged pool gives the dense cache's tokens, and cuda
                # the cpu's
                ref_dev = devices[-1]
                for prompt, ids in runs[cache, devices[0]]["tokens"].items():
                    for other in devices[1:]:
                        agree(f"{preset} {cache} {devices[0]} vs {other}",
                              ids, runs[cache, other]["tokens"][prompt],
                              engines[other][0], list(prompt))
                    if cache == "paged":
                        agree(f"{preset} paged vs dense", ids,
                              runs["dense", devices[0]]["tokens"][prompt],
                              engines[ref_dev][0], list(prompt))
            result[preset] = out
    return result


SERVE_NEED = ("qmatmul", "fused_head", "flash_prefill", "flash_decode_paged")


SERVED: dict[str, dict] = {}  # phase -> {prompt ids: generated ids}


def synthetic_tokenizer(vocab_size: int):
    """The tokenizer of tools/synthetic.py's workspaces (specials, bytes,
    filler tokens) at `vocab_size`."""
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tokenizer.vocab import GGUFVocab
    from powerserve_tpu_torch.tools.synthetic import _simple_vocab

    toks, scores, types = _simple_vocab(vocab_size)
    return Tokenizer(vocab=GGUFVocab.from_metadata({
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
        "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0}),
        bos_id=1, eos_id=2, stop_ids={2}, add_bos=True)


def phase_serve_full_width(dev: torch.device, cfg, model, phase: str,
                           need: tuple = SERVE_NEED,
                           model_name: str = "model", spec_tree: str = "",
                           reference: str | None = None,
                           sampled: bool = False) -> tuple[dict, dict]:
    """A full-width model (random weights) behind the HTTP server: 8 slots
    over a paged pool of 128 pages of 64 tokens (half of 8 x 2048, yet
    enough for all eight at once), 8 concurrent greedy requests with
    prompts of 128-1024 tokens and 64 new tokens each, to the model name
    `model_name` ("model", or a speculative "model+self:N", with
    spec_tree its token tree's widths); every kernel in `need` must
    launch. The traffic is served twice: with the decode ticks replayed
    (a speculative name's greedy ticks replay their speculative steps),
    then with every step eager (the twin), whose requests must get the
    same tokens (near-tie rule). With `reference` (an earlier phase of
    this run) every request must get that phase's tokens too; with
    `sampled`, one more request at temperature 0.8 with a seed must end
    without "error"."""
    import random

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    tok = synthetic_tokenizer(cfg.llm.vocab_size)
    n_new, lengths = 64, [128, 256, 384, 512, 640, 768, 896, 1024]
    rng = random.Random(0)
    # one byte token per letter, after the BOS and the 3-byte space prefix
    texts = ["".join(rng.choice("abcdefghijklmnopqrsuvwxyz")
                     for _ in range(n - 4)) for n in lengths]
    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=128, page_size=64, spec_tree=spec_tree)

    def serve_once(label: str) -> dict:
        torch.cuda.reset_peak_memory_stats(dev)
        with tempfile.TemporaryDirectory() as tmp:
            ctx = ServerContext(tmp, "model", hp, dev)
            ctx.register("model", model, cfg, tok)
            server = serving(ctx)
            port = server.server_address[1]
            try:
                sched = ctx.get(model_name).scheduler
                pool = sched.pool
                calls = [lambda t=t: http_call(
                    port, "POST", "/v1/completions", {
                        "model": model_name, "prompt": t,
                        "max_tokens": n_new, "temperature": 0})
                    for t in texts]
                peak_used = [0]
                done = threading.Event()

                def watch():
                    while not done.is_set():
                        peak_used[0] = max(peak_used[0],
                                           pool.n_pages - pool.n_free)
                        time.sleep(0.02)

                watcher = threading.Thread(target=watch, daemon=True)
                with ServeRecorder() as rec:
                    cuda_lib.reset_launch_counts()
                    watcher.start()
                    t0 = time.perf_counter()
                    replies = concurrently(calls)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    done.set()
                    launches = cuda_lib.launch_counts()
                watcher.join(timeout=5)
                rec.check(label)
                finish = []
                for status, data in replies:
                    if status != 200:
                        raise AssertionError(f"{label}: {status} "
                                             f"{data[:200]}")
                    finish.append(
                        json.loads(data)["choices"][0]["finish_reason"])
                tokens = rec.tokens()
                n_tokens = [len(ids) for ids in tokens.values()]
                if finish != ["length"] * 8 or n_tokens != [n_new] * 8:
                    raise AssertionError(f"{label}: finish {finish}, "
                                         f"tokens {n_tokens}")
                missing = [k for k in need if not launches[k]]
                if missing:
                    raise AssertionError(f"{label} did not launch "
                                         f"{missing}: {launches}")
                metrics = metrics_of(port)
                graphs = graph_stats(sched.graphs)
                del sched
                draw = None
                if sampled:
                    with ServeRecorder() as rec2:
                        status, data = http_call(
                            port, "POST", "/v1/completions", {
                                "model": model_name, "prompt": texts[0],
                                "max_tokens": 16, "temperature": 0.8,
                                "seed": 5})
                    rec2.check(f"{label} sampled")
                    reply = json.loads(data)["choices"][0]
                    if status != 200 or reply["finish_reason"] == "error":
                        raise AssertionError(f"{label} sampled: {status} "
                                             f"{data[:200]}")
                    draw = dict(finish_reason=reply["finish_reason"],
                                tokens=len(next(iter(
                                    rec2.tokens().values()))))
            finally:
                server.shutdown()
                server.server_close()
                ctx.close()
        return dict(tokens=tokens, wall=wall, launches=launches,
                    metrics=metrics, peak_used=peak_used[0], graphs=graphs,
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    sampled=draw)

    run = serve_once(phase)
    with eager_steps():
        twin = serve_once(f"{phase} eager twin")
    # the shortest and the longest request against a lone generate, and
    # every request of the twin against the replayed run
    ehp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=128)
    ehp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, ehp, eos_id=2, device=dev)
    gaps, twin_gaps = [], []
    tokens = run["tokens"]
    by_len = sorted(tokens.items(), key=lambda kv_: len(kv_[0]))
    for prompt, ids in (by_len[0], by_len[-1]):
        engine.reset()
        want = list(engine.generate(list(prompt), n_new,
                                    stop_fn=tok.should_stop))
        gaps.append(agree(f"{phase} vs generate", ids, want, engine,
                          list(prompt)))
    for prompt, ids in tokens.items():
        twin_gaps.append(agree(f"{phase} vs its eager twin", ids,
                               twin["tokens"][prompt], engine,
                               list(prompt)))
    ref_gaps = []
    for prompt, ids in (tokens.items() if reference else ()):
        ref_gaps.append(agree(f"{phase} vs {reference}", ids,
                              SERVED[reference][prompt], engine,
                              list(prompt)))
    SERVED[phase] = tokens
    del engine
    metrics = run["metrics"]
    spec = {key: metrics[key] for key in (
        "spec_accept_rate", "spec_tokens_per_step") if key in metrics}
    out = {"phase": phase, "slots": 8, "pool_pages": 128, "page": 64,
           "prompt_tokens": sorted(len(p) for p in tokens),
           "new_tokens": n_new, "wall_s": run["wall"],
           "generated_tok_s": 8 * n_new / run["wall"],
           "ttft_p50_s": metrics["ttft_seconds_p50"],
           "ttft_p90_s": metrics["ttft_seconds_p90"],
           "latency_p50_s": metrics["request_latency_seconds_p50"],
           "pages_used_peak": run["peak_used"],
           "preemptions": metrics["paged_preemptions_total"],
           "paged_slow_ticks": metrics.get("paged_slow_ticks"),
           "vs_generate_near_ties": [g for g in gaps if g is not None],
           "model": model_name, **spec, "graphs": run["graphs"],
           "launches": run["launches"], "peak_mem_gb": run["peak_gb"],
           "card": card_line()}
    if spec_tree:
        out["spec_tree"] = spec_tree
    if reference:
        out[f"vs_{reference}_near_ties"] = [g for g in ref_gaps
                                            if g is not None]
    if sampled:
        out["sampled_request"] = run["sampled"]
    tm = twin["metrics"]
    out["eager_twin"] = {
        "wall_s": twin["wall"], "generated_tok_s": 8 * n_new / twin["wall"],
        "ttft_p50_s": tm["ttft_seconds_p50"],
        "ttft_p90_s": tm["ttft_seconds_p90"],
        "latency_p50_s": tm["request_latency_seconds_p50"],
        "vs_replayed_near_ties": [g for g in twin_gaps if g is not None]}
    return out, run["launches"]


class TickClock:
    """While active: CUDA events around every step-graph call made inside
    a decode tick of the scheduler `sched` (other schedulers' ticks are
    left alone), and each tick's host wall time. summary()
    splits the steady ticks (none right after a prefill tick) into the
    card's replay time (a tick's first graph call to its last) and the
    card's wait between one tick's last replay and the next tick's first
    (the host time the replays did not hide). A tick without a graph
    call (an eager spec tick of a tree before its sampled graphs) counts
    only in its host time."""

    def __init__(self, sched):
        self.sched = sched

    def __enter__(self):
        from unittest import mock

        from powerserve_tpu_torch.engine.graphs import StepGraph
        from powerserve_tpu_torch.engine.scheduler import BatchScheduler

        self.ticks: list[dict] = []
        self.host: list[float] = []
        self.busy = 0  # ticks entered with a decoding slot
        self.cur = self.thread = None
        self.after_prefill = False
        call = StepGraph.__call__
        tick = BatchScheduler._decode_tick
        prefill = BatchScheduler._prefill_tick
        clock = self

        def timed_call(graph):
            if clock.cur is None or clock.thread != threading.get_ident():
                return call(graph)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = call(graph)
            e1.record()
            clock.cur["events"].append((e0, e1))
            return out

        def timed_tick(sched):
            if sched is not clock.sched:
                return tick(sched)
            clock.thread = threading.get_ident()
            clock.busy += any(s.req is not None and not s.prefilling
                              for s in sched.slots)
            clock.cur = dict(events=[], after_prefill=clock.after_prefill)
            clock.after_prefill = False
            t0 = time.perf_counter()
            try:
                return tick(sched)
            finally:
                clock.host.append(time.perf_counter() - t0)
                if clock.cur["events"]:
                    clock.ticks.append(clock.cur)
                clock.cur = None

        def timed_prefill(sched):
            ran = prefill(sched)
            if sched is clock.sched:
                clock.after_prefill = clock.after_prefill or bool(ran)
            return ran

        self._patches = [mock.patch.object(StepGraph, "__call__", timed_call),
                         mock.patch.object(BatchScheduler, "_decode_tick",
                                           timed_tick),
                         mock.patch.object(BatchScheduler, "_prefill_tick",
                                           timed_prefill)]
        for p_ in self._patches:
            p_.start()
        return self

    def __exit__(self, *exc):
        for p_ in self._patches:
            p_.stop()
        # the patches' closures refer to this clock: drop them and the
        # scheduler, or the cycle keeps its caches until a collection
        self._patches = self.sched = None
        return False

    def summary(self) -> dict:
        torch.cuda.synchronize()
        replay, gap = [], []
        for a, b in zip(self.ticks, self.ticks[1:] + [None]):
            replay.append(a["events"][0][0].elapsed_time(a["events"][-1][1]))
            if b is not None and not b["after_prefill"]:
                gap.append(a["events"][-1][1].elapsed_time(b["events"][0][0]))
        steady = replay[:len(gap)]

        def med(xs):
            return statistics.median(xs) if xs else None

        return {"ticks": len(self.host), "decoding_ticks": self.busy,
                "graph_ticks": len(self.ticks),
                "graph_calls": sum(len(t["events"]) for t in self.ticks),
                "tick_host_ms_p50": med([h * 1e3 for h in self.host]),
                "tick_replay_ms_p50": med(replay),
                "tick_gap_ms_p50": med(gap), "steady_ticks": len(gap),
                "card_wait_share": (sum(gap) / (sum(gap) + sum(steady))
                                    if gap else None)}


def phase_sampled_serve(dev: torch.device, cfg, model,
                        check: bool = True) -> tuple[dict, dict]:
    """serve_full_width's traffic (8 slots, 128 pages of 64, 8 requests
    of 128-1024 prompt tokens and 64 new ones at once) on one server
    without a prefix cache (every run prefills its prompts), in this
    order: greedy on "model" twice (the first warms the server: its
    graph's capture, the allocator); at temperature 0.8 with seeds 0..7
    (the server's default temperature), twice; request 3 alone with its
    seed; at 0.8 with the seeds on "model+self:4" (chain speculation, a
    4-layer self-draft). Each run: generated tok/s, TTFT p50, the paged
    pool's slow ticks and preemptions, and the plain or spec tick split
    on the card (TickClock). check: the seeded replies reproduce (twice,
    and alone), and every decode step of a sampled run went through a
    graph (each step graph's first call eager, every other one a
    replay); off where the script runs in an older tree, to measure it."""
    import random

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    tok = synthetic_tokenizer(cfg.llm.vocab_size)
    n_new, lengths = 64, [128, 256, 384, 512, 640, 768, 896, 1024]
    rng = random.Random(0)
    texts = ["".join(rng.choice("abcdefghijklmnopqrsuvwxyz")
                     for _ in range(n - 4)) for n in lengths]
    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=128, page_size=64, prefix_cache=0)
    out, launches = {"phase": "sampled_serve", "card": card_line()}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = ServerContext(tmp, "model", hp, dev)
        ctx.register("model", model, cfg, tok)
        server = serving(ctx)
        port = server.server_address[1]
        try:
            for label, name, temp, which in (
                    ("warm", "model", 0.0, range(8)),
                    ("greedy", "model", 0.0, range(8)),
                    ("sampled", "model", 0.8, range(8)),
                    ("sampled_again", "model", 0.8, range(8)),
                    ("sampled_alone", "model", 0.8, [3]),
                    ("self4_sampled", "model+self:4", 0.8, range(8))):
                sched = ctx.get(name).scheduler
                sched._ttft.clear()
                before = metrics_of(port)
                g0 = graph_stats(sched.graphs)
                calls = [lambda i=i: http_call(
                    port, "POST", "/v1/completions", {
                        "model": name, "prompt": texts[i],
                        "max_tokens": n_new, "temperature": temp,
                        "seed": i}) for i in which]
                with ServeRecorder() as rec, TickClock(sched) as clock:
                    cuda_lib.reset_launch_counts()
                    t0 = time.perf_counter()
                    replies = concurrently(calls)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts = cuda_lib.launch_counts()
                rec.check(label)
                if any(st != 200 for st, _ in replies):
                    raise AssertionError(f"{label}: {replies[0][1][:200]}")
                tokens = rec.tokens()
                m = metrics_of(port)
                g1 = graph_stats(sched.graphs)
                split = clock.summary()
                run = {"wall_s": wall,
                       "generated_tok_s": sum(map(len, tokens.values()))
                       / wall,
                       "ttft_p50_s": m["ttft_seconds_p50"],
                       "paged_slow_ticks": m.get("paged_slow_ticks", 0)
                       - before.get("paged_slow_ticks", 0),
                       "preemptions": m["paged_preemptions_total"]
                       - before["paged_preemptions_total"],
                       "graph_replays": g1["replays"] - g0["replays"],
                       "graphs": g1["graphs"], **split,
                       "sample_launches": counts.get("sample", 0)}
                if "spec_tokens_per_step" in m:
                    run["spec_tokens_per_step"] = m["spec_tokens_per_step"]
                out[label] = run
                launches[label] = counts
                out.setdefault("tokens", {})[label] = tokens
                if check and temp > 0:
                    # every decode step through a graph: each tick with a
                    # decoding slot made one graph call a step, and all
                    # but a step graph's first (eager) call replayed
                    steps = hp.decode_horizon if name == "model" \
                        else hp.spec_horizon
                    eager = split["graph_calls"] - run["graph_replays"]
                    if (split["graph_ticks"] != split["decoding_ticks"]
                            or split["graph_calls"]
                            != steps * split["graph_ticks"]
                            or eager > 2 or not run["sample_launches"]):
                        raise AssertionError(f"{label}: eager steps: {run}")
                    run["eager_steps"] = eager
        finally:
            server.shutdown()
            server.server_close()
            ctx.close()
    toks = out.pop("tokens")
    if check:
        if toks["sampled"] != toks["sampled_again"]:
            raise AssertionError("sampled: seeded replies differ between "
                                 "two runs")
        (prompt, ids), = toks["sampled_alone"].items()
        if toks["sampled"][prompt] != ids:
            raise AssertionError("sampled: request 3 alone differs from "
                                 "its reply beside seven others")
    out["reproduced"] = check
    return out, launches


def phase_session_full_width(dev: torch.device, cfg, model) -> dict:
    """An HTTP session on a full-width model (random weights) behind the
    server: 8 slots, max_seq 2048, a paged pool of 256 pages of 64 (no
    preemption at these lengths). A 1,536-token preamble becomes session
    "agent"; then 8 concurrent greedy requests, each the session and
    64-256 tokens of its own (from seed 1), 32 new tokens each: with the
    pinned snapshot (a hit), with the prefix cache cleared (a whole
    re-prefill), and from the session's file after DELETE and load_path.
    Every reply is the hit run's (near-tie rule), the hit run launches
    fewer prefill kernels; TTFT of each run, the file's bytes, its save
    and load seconds. serve_full_width's traffic is served with and
    without session loads running back to back beside it. The same
    session on "model+self:4" (its draft cache's prefix pinned too)
    gives the plain name's replies."""
    import os
    import random

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    tok = synthetic_tokenizer(cfg.llm.vocab_size)
    rng = random.Random(1)
    letters = "abcdefghijklmnopqrsuvwxyz"

    def text(n):  # n tokens: the BOS, the space prefix's 3 bytes, letters
        return "".join(rng.choice(letters) for _ in range(n - 4))

    preamble = text(1536)
    texts = [text(rng.randrange(64, 257)) for _ in range(8)]
    rng2 = random.Random(0)  # serve_full_width's traffic
    serve_texts = ["".join(rng2.choice(letters) for _ in range(n - 4))
                   for n in (128, 256, 384, 512, 640, 768, 896, 1024)]
    n_new = 32
    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=256, page_size=64)
    out = {"phase": "session_full_width", "slots": 8, "pool_pages": 256,
           "page": 64, "session_tokens": 1536, "new_tokens": n_new}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = ServerContext(tmp, "model", hp, dev)
        ctx.register("model", model, cfg, tok)
        server = serving(ctx)
        port = server.server_address[1]

        def post(path, body):
            status, data = http_call(port, "POST", path, body)
            if status != 200:
                raise AssertionError(f"{path}: {status} {data[:200]}")
            return json.loads(data)

        def timed_post(path, body):
            t0 = time.perf_counter()
            post(path, body)
            return time.perf_counter() - t0

        def traffic(label, prompts, name="model", session="agent",
                    max_tokens=n_new):
            sched = ctx.get(name).scheduler
            sched._ttft.clear()
            hits = sched.prefix_cache.hits
            body = {"model": name, "max_tokens": max_tokens,
                    "temperature": 0}
            if session:
                body["session"] = session
            calls = [lambda t=t: http_call(port, "POST", "/v1/completions",
                                           {**body, "prompt": t})
                     for t in prompts]
            with ServeRecorder() as rec:
                cuda_lib.reset_launch_counts()
                t0 = time.perf_counter()
                replies = concurrently(calls)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = cuda_lib.launch_counts()
            rec.check(label)
            for status, data in replies:
                if (status != 200 or json.loads(data)["choices"][0][
                        "finish_reason"] != "length"):
                    raise AssertionError(f"{label}: {status} {data[:200]}")
            m = sched.metrics()
            return dict(tokens=rec.tokens(), wall_s=wall,
                        generated_tok_s=len(prompts) * max_tokens / wall,
                        ttft_p50_s=m["ttft_seconds_p50"],
                        ttft_p90_s=m["ttft_seconds_p90"],
                        prefix_hits=sched.prefix_cache.hits - hits,
                        launches={k: launches[k] for k in (
                            "flash_prefill", "qmatmul", "flash_decode_paged",
                            "flash_decode_paged_state")})

        try:
            sched = ctx.get("model").scheduler
            path = f"{tmp}/agent.npz"
            out["create_s"] = timed_post("/v1/sessions", {
                "model": "model", "prompt": preamble, "id": "agent"})
            ids = ctx.sessions["agent"]["ids"]
            if len(ids) != 1536:
                raise AssertionError(f"the preamble is {len(ids)} tokens")
            entry = sched.prefix_cache.entries[tuple(ids)]
            out["snapshot_mb"] = sum(t.numel() * t.element_size()
                                     for t in entry.values()
                                     if torch.is_tensor(t)) / 1e6
            # the same session again with save_path: its prefix is a whole
            # hit, so the call is one decode tick and the save
            out["save_s"] = timed_post("/v1/sessions", {
                "model": "model", "prompt": preamble, "id": "agent",
                "save_path": path})
            out["file_bytes"] = os.path.getsize(path)
            runs = {"hit": traffic("session hit", texts)}
            sched.clear_prefixes()
            runs["cleared"] = traffic("session cleared", texts)
            sched.clear_prefixes()  # the cleared run's own entries too
            http_call(port, "DELETE", "/v1/sessions/agent")
            out["load_s"] = timed_post("/v1/sessions", {
                "model": "model", "id": "agent", "load_path": path})
            runs["restored"] = traffic("session restored", texts)
            if runs["hit"]["prefix_hits"] != 8 or runs["restored"][
                    "prefix_hits"] != 8 or runs["cleared"]["prefix_hits"]:
                raise AssertionError(f"prefix hits: "
                                     f"{[r['prefix_hits'] for r in runs.values()]}")
            if not (runs["hit"]["launches"]["flash_prefill"]
                    < runs["cleared"]["launches"]["flash_prefill"]):
                raise AssertionError("a hit launched as many prefill kernels "
                                     "as the whole re-prefill")
            # serve_full_width's traffic alone and beside session loads
            # run back to back: the server's (the file inflated by a child
            # process) and, for comparison, load_session in the handler
            # thread; in turns, alone first and last
            from unittest import mock

            from powerserve_tpu_torch.kv.persist import load_session

            def beside(label, in_thread=False):
                sched.clear_prefixes()
                stop, loads = threading.Event(), []

                def load_loop():
                    while not stop.is_set():
                        loads.append(timed_post("/v1/sessions", {
                            "model": "model", "id": "bg",
                            "load_path": path}))

                loader = threading.Thread(target=load_loop, daemon=True)
                patch = mock.patch(
                    "powerserve_tpu_torch.serving.server.load_session_apart",
                    load_session) if in_thread else contextlib.nullcontext()
                with patch:
                    if label != "alone":
                        loader.start()
                    try:
                        r = traffic(f"serve traffic {label}", serve_texts,
                                    session=None, max_tokens=64)
                    finally:
                        stop.set()
                        if label != "alone":
                            loader.join(timeout=120)
                r["loads"] = loads
                return r

            order = [("alone", False), ("beside_loads", False),
                     ("beside_loads_in_thread", True), ("beside_loads", False),
                     ("beside_loads_in_thread", True), ("alone", False)]
            contention: dict[str, list] = {}
            for label, in_thread in order:
                r = beside(label, in_thread)
                contention.setdefault(label, []).append(r)
            alone = contention["alone"][0]
            runs["serve_beside_loads"] = contention["beside_loads"][0]
            out["serve_traffic"] = {
                label: {"generated_tok_s": [r["generated_tok_s"] for r in rs],
                        "ttft_p50_s": [r["ttft_p50_s"] for r in rs],
                        "loads_during": [len(r["loads"]) for r in rs],
                        "load_s_median": [statistics.median(r["loads"])
                                          if r["loads"] else None
                                          for r in rs]}
                for label, rs in contention.items()}
            # the same session on a self-draft name: both caches pinned
            post("/v1/sessions", {"model": "model+self:4",
                                  "prompt": preamble, "id": "agent4"})
            spec = ctx.get("model+self:4").scheduler
            if "draft" not in spec.prefix_cache.entries[tuple(ids)]:
                raise AssertionError("model+self:4: no draft prefix pinned")
            runs["self_draft_4"] = traffic("session model+self:4", texts,
                                           name="model+self:4",
                                           session="agent4")
        finally:
            server.shutdown()
            server.server_close()
            ctx.close()
    ehp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=128)
    ehp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, ehp, eos_id=2, device=dev)
    gaps = []
    for label, ref in (("cleared", runs["hit"]), ("restored", runs["hit"]),
                       ("self_draft_4", runs["hit"]),
                       ("serve_beside_loads", alone)):
        for prompt, ids_ in ref["tokens"].items():
            gaps.append(agree(f"session {label}", runs[label]["tokens"][
                prompt], ids_, engine, list(prompt)))
    del engine
    for label, r in runs.items():
        if label != "serve_beside_loads":
            out[label] = {k: v for k, v in r.items() if k != "tokens"}
    out["near_ties"] = [g for g in gaps if g is not None]
    out["card"] = card_line()
    return out


def phase_evict(dev: torch.device) -> dict:
    """Multi-model eviction at llama-1b's widths (dim 2048, ffn 8192, 32
    heads, 8 kv heads; 2 layers and a 32,000-token vocabulary, which
    quarters the numpy write; random Q8_0 weights: one GGUF linked into
    three model dirs, each loaded on its own):
    ServerContext(max_models=2) serves a, b, c, a, one request each (its
    decode steps captured as graphs, its prompt stored in the prefix
    cache). Each eviction must give back what its context took when it
    loaded and served (weights, paged pool, buffers, snapshots), within
    5% of the allocated bytes, and leave no segment of its graphs' memory
    pool; memory_allocated and memory_reserved before and after each."""
    import os
    from unittest import mock

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.graphs import pool_bytes
    from powerserve_tpu_torch.engine.scheduler import Request
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    out = {"phase": "evict", "preset": "llama-1b", "layers": 2,
           "vocab": 32000, "quant": "q8_0", "max_models": 2}
    hp = HyperParams(max_slots=4, max_seq_len=1024, batch_size=128,
                     paged_pages=64, page_size=64)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_synthetic_gguf(f"{tmp}/ws", "llama-1b", GGMLType.Q8_0, seed=0,
                            seq_len=1024, layers=2, vocab=32000)
        out["write_s"] = time.perf_counter() - t0
        for name in ("a", "b", "c"):
            os.makedirs(f"{tmp}/models/{name}")
            os.symlink(f"{tmp}/ws/model/weights.gguf",
                       f"{tmp}/models/{name}/weights.gguf")
        ctx = ServerContext(f"{tmp}/models", "a", hp, dev, max_models=2)
        held, evictions = {}, []
        release = ServerContext._release

        def recorded(self, mctx):
            torch.cuda.synchronize()
            before = (torch.cuda.memory_allocated(dev),
                      torch.cuda.memory_reserved(dev))
            pool = tuple(mctx.scheduler.graphs.pool)
            pool_b = pool_bytes(mctx.scheduler.graphs)
            release(self, mctx)
            torch.cuda.synchronize()
            left = [seg for seg in torch.cuda.memory_snapshot()
                    if tuple(seg["segment_pool_id"]) == pool]
            evictions.append(dict(
                name=mctx.name, allocated_before=before[0],
                reserved_before=before[1],
                allocated_after=torch.cuda.memory_allocated(dev),
                reserved_after=torch.cuda.memory_reserved(dev),
                graph_pool_bytes=pool_b, graph_pool_segments_left=len(left)))

        t0 = time.perf_counter()
        try:
            with mock.patch.object(ServerContext, "_release", recorded):
                for name in ("a", "b", "c", "a"):
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    base = torch.cuda.memory_allocated(dev)
                    n_ev = len(evictions)
                    sched = ctx.get(name).scheduler
                    done = threading.Event()
                    sched.submit(Request(
                        prompt_ids=list(range(3, 67)), max_tokens=16,
                        temperature=0.0,
                        sink=lambda t, d=done: t is None and d.set()))
                    if not done.wait(timeout=300):
                        raise AssertionError(f"{name}: the request hung")
                    torch.cuda.synchronize()
                    if not any(g.graph is not None
                               for g in sched.graphs.graphs.values()):
                        raise AssertionError(f"{name}: no step graph")
                    # what this context took, less what an eviction in its
                    # get() gave back meanwhile
                    freed = sum(e["allocated_before"] - e["allocated_after"]
                                for e in evictions[n_ev:])
                    held[name] = torch.cuda.memory_allocated(dev) - base + freed
                    del sched
        finally:
            ctx.close()
        out["seconds"] = time.perf_counter() - t0
    if [e["name"] for e in evictions] != ["a", "b"]:
        raise AssertionError(f"evicted {[e['name'] for e in evictions]}, "
                             f"not a then b")
    for e in evictions:
        e["held_bytes"] = held[e["name"]]
        e["freed_bytes"] = e["allocated_before"] - e["allocated_after"]
        e["freed_share"] = e["freed_bytes"] / e["held_bytes"]
        if abs(e["freed_share"] - 1) > 0.05 or e["graph_pool_segments_left"]:
            raise AssertionError(f"eviction of {e['name']} gave back "
                                 f"{e['freed_bytes']} of {e['held_bytes']} "
                                 f"bytes, {e['graph_pool_segments_left']} "
                                 f"graph pool segments left")
    out["evictions"] = evictions
    out["card"] = card_line()
    return out


class Clock:
    """A model whose every call is synchronized and timed (wall seconds
    summed in .seconds), for a breakdown of a speculative tick."""

    def __init__(self, model):
        self.model, self.llm, self.seconds, self.calls = model, model.llm, 0.0, 0

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.model(*args, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def spec_tick_breakdown(dev, model, llm, g) -> dict:
    """Where one scheduler spec tick of llama-8b+self:4 goes: 8 greedy
    slots with 512 committed positions each on a paged pool (pages of 64),
    hp.spec_horizon = 2 steps of k = 4, each forward synchronized and
    timed: draft forwards, verifies, the rest (sampling, acceptance,
    rollback), and the tick's one host fetch. Then the same tick with
    its steps replayed as the scheduler replays them
    (sample_step's graph without draws, warmed and captured first)."""
    from powerserve_tpu_torch.engine.graphs import StepGraphs
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
    from powerserve_tpu_torch.speculative.chain import (
        chain_spec_sample_scan, sample_step, self_draft_model)

    S, n, H, k, page = 8, 512, 2, 4, 64
    t_kv = PagedKVCache.create(llm.n_layers, S, 2048, llm.n_kv_heads,
                               llm.head_size, dev, n_pages=128,
                               page_size=page)
    pool = PagePool(128, S, t_kv.max_pages, page)
    for s_ in range(S):
        # room for the eager ticks and the replayed ones
        pool.ensure(s_, n + 6 * H * (k + 1) + k + 1)
    pool.flush(t_kv)
    draft = self_draft_model(model, 4)
    d_kv = KVCache.create(4, S, 2048, llm.n_kv_heads, llm.head_size, dev)
    toks = torch.randint(3, llm.vocab_size, (S, n), generator=g).to(dev)
    pos = torch.arange(n, device=dev).expand(S, n)
    model(t_kv, toks, pos, logits_mode="none")
    draft(d_kv, toks, pos, logits_mode="none")
    root = toks[:, -1].clone()
    zeros = torch.zeros(S, device=dev)
    args = (root, H, k, torch.ones(S, dtype=torch.bool, device=dev),
            None, zeros, torch.full((S,), 40, device=dev),
            torch.ones(S, device=dev))
    tc, dc = Clock(model), Clock(draft)
    chain_spec_sample_scan(tc, dc, t_kv, d_kv, *args)  # warm
    tc.seconds = dc.seconds = 0.0
    tc.calls = dc.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emitted, counts, nxt = chain_spec_sample_scan(tc, dc, t_kv, d_kv, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cat([emitted.flatten(), counts.flatten(), nxt]).cpu()
    fetch = time.perf_counter() - t1
    total = t1 - t0 + fetch
    # the replayed tick: the scheduler's buffers and step graph
    z = lambda *shape: torch.zeros(shape, dtype=torch.int64,  # noqa: E731
                                   device=dev)
    bufs = dict(root=nxt.clone(), active=args[3], temp=args[5],
                top_k=args[6], top_p=args[7], step=z(1),
                spec_emitted=z(H, S, k + 1), spec_counts=z(H, S))
    graphs = StepGraphs(dev)
    g = graphs.step(("spec",), lambda: (sample_step(
        model, draft, t_kv, d_kv, bufs, k, None), bufs))

    def tick():
        bufs["step"].zero_()
        for _ in range(H):
            g()
        return torch.cat([bufs["spec_emitted"].flatten(),
                          bufs["spec_counts"].flatten(), bufs["root"]]).cpu()

    tick()  # one step eager, the other captured
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tick()
    replayed = time.perf_counter() - t2
    return dict(slots=S, committed=n, steps=H, k=k, tick_ms=total * 1e3,
                draft_ms=dc.seconds * 1e3, verify_ms=tc.seconds * 1e3,
                other_ms=(t1 - t0 - dc.seconds - tc.seconds) * 1e3,
                fetch_ms=fetch * 1e3, draft_calls=dc.calls,
                verify_calls=tc.calls, replayed_tick_ms=replayed * 1e3,
                capture_s=g.capture_s)


def phase_spec_full_width(dev: torch.device, cfg, model,
                          serve_traffic) -> tuple[dict, dict]:
    """Chain speculation on llama-8b Q4_K (random weights, which accept few
    drafts: acceptance is reported, not held):
      (a) ChainSpecEngine with a 4-layer self-draft (the fused layer
          chain), k = 4, a 512-token prompt and 64 greedy tokens, against
          InferenceEngine.generate's tokens (near-tie rule);
      (b) the same with a separate llama-1b Q4_K draft;
      (c) the 4-layer self-draft with its lm_head factored to rank 512;
      (d) "llama-8b+self:4" behind the HTTP server with serve_full_width's
          traffic on its paged pool (8 slots), whose verifies take the
          deferred route through the state mode;
      (e) one paged verify forward (S = 8 slots of 5 rows) through the
          deferred route against the inline one: logits within LOGIT_REL;
          after the commit the pool holds what per-layer writes of the
          same K/V would, and layer 0 (computed before any attention)
          holds the inline route's bits.
    Returns the phase's line and each path's launch counts."""
    from unittest import mock

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
    from powerserve_tpu_torch.speculative.chain import (ChainSpecEngine,
                                                        chain_spec_scan,
                                                        with_draft_head)
    from powerserve_tpu_torch.speculative.draft_head import make_draft_head
    from powerserve_tpu_torch.speculative.engine import SpecStats
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    llm = cfg.llm
    n_prompt, n_new, max_seq, k = 512, 64, 2048, 4
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    prompt = prompt.tolist()
    hp = HyperParams(max_slots=1, max_seq_len=max_seq, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    counted = Counted()
    want, plain_s = counted("plain generate", ("qmatmul", "fused_head"),
                            lambda: list(engine.generate(prompt, n_new)))
    out: dict = {"phase": "spec_full_width", "k": k,
                 "prompt_tokens": n_prompt, "new_tokens": n_new,
                 "plain_decode_tok_s": n_new / plain_s}

    def spec_run(label, need, sync_check=False, **kw):
        """ChainSpecEngine.generate with its chain steps replayed, then
        its eager twin (a new engine, every step eager): the same tokens
        and launch counts. With sync_check, one more replayed block
        under set_sync_debug_mode("error")."""
        draft_head = kw.pop("draft_head", None)
        runs = {}
        for path in (label, f"{label} eager"):
            eng = ChainSpecEngine(model, cfg, k=k, block_steps=8,
                                  max_seq=max_seq, prefill_chunk=n_prompt,
                                  device=dev, **kw)
            if draft_head is not None:
                eng.draft = with_draft_head(eng.draft, draft_head)
            runs[path] = []
            with (eager_steps() if path.endswith("eager")
                  else contextlib.nullcontext()):
                for again in (False, True):  # the second call steady
                    stats = SpecStats()
                    got, secs = counted(path + " again" * again, need,
                                        lambda: list(eng.generate(
                                            prompt, n_new, stats=stats)))
                    if len(got) != n_new:
                        raise AssertionError(f"{path}: {len(got)} tokens")
                    runs[path].append((got, stats, secs))
            if path == label:
                graphs = graph_stats(graphs_of(eng.t_kv))
            if sync_check and path == label:
                without_sync(f"spec_full_width {label} replayed chain step",
                             lambda: chain_spec_scan(
                                 eng.target, eng.draft, eng.t_kv, eng.d_kv,
                                 eng._root, 8, k))
            del eng
        got, stats, secs = runs[label][0]
        if {tuple(r[0]) for rs in runs.values() for r in rs} != {tuple(got)}:
            raise AssertionError(f"{label}: replayed chain steps {got} != "
                                 f"the eager twin's or the second call's")
        same_launches(label, counted.launches, label, f"{label} eager")
        tok_s = lambda r: n_new / (r[1].decode_ms / 1e3)  # noqa: E731
        out[label] = dict(
            accept_rate=stats.accept_rate,
            tokens_per_step=stats.tokens_per_step, steps=stats.steps,
            decode_tok_s=tok_s(runs[label][0]),
            decode_again_tok_s=tok_s(runs[label][1]),
            eager_decode_tok_s=tok_s(runs[f"{label} eager"][0]),
            eager_decode_again_tok_s=tok_s(runs[f"{label} eager"][1]),
            wall_s=secs, graphs=graphs, replay_equals_eager=True,
            replayed_chain_step_sync_free=sync_check,
            vs_generate_near_tie=agree(
                f"spec_full_width {label}", got, want, engine, prompt))

    # (a) the fused chain of a shallow self-draft, (b) a separate draft
    spec_run("self_draft_4", SPEC_NEED, sync_check=True,
             self_draft_layers=4)
    _, d_model = make_device_params("llama-1b", "q4_k", seed=1,
                                    device=dev)
    spec_run("draft_llama_1b", ("qmatmul", "fused_head", "flash_decode"),
             draft=d_model)
    del d_model
    torch.cuda.empty_cache()
    # (c) the factored draft head: norm -> U, then V with the argmax
    t0 = time.perf_counter()
    head_lr = make_draft_head(model.lm_head, rank=512)
    torch.cuda.synchronize()
    out["draft_head_build_s"] = time.perf_counter() - t0
    spec_run("self_draft_4_head_rank_512", SPEC_NEED + ("fused_x_argmax",),
             self_draft_layers=4, draft_head=head_lr)
    del head_lr
    torch.cuda.empty_cache()
    # (d) behind the server: the state mode on the paged verify
    # the draft cache is dense; the target's verify reads the pool only
    # through the state mode
    serve, _ = serve_traffic(dev, cfg, model, "spec_full_width serve",
                             SPEC_NEED + ("flash_prefill",
                                          "flash_decode_paged_state"),
                             "model+self:4")
    counted.launches["serve"] = serve.pop("launches")
    out["serve"] = serve

    out["tick_breakdown"] = spec_tick_breakdown(dev, model, llm, g)

    # (e) one paged verify, deferred against inline
    S, Tq, page = 8, k + 1, 64
    kv = PagedKVCache.create(llm.n_layers, S, max_seq, llm.n_kv_heads,
                             llm.head_size, dev, n_pages=128,
                             page_size=page)
    pool = PagePool(128, S, kv.max_pages, page)
    lens = [128 * (s_ + 1) - 7 * s_ for s_ in range(S)]
    for s_, n_ in enumerate(lens):
        if not pool.ensure(s_, n_ + Tq):
            raise AssertionError("verify pool too small")
    pool.flush(kv)
    L = max(lens)
    toks = torch.randint(3, llm.vocab_size, (S, L), generator=g).to(dev)
    pos = torch.arange(L, device=dev).expand(S, L).clone()
    pos[pos >= torch.tensor(lens, device=dev)[:, None]] = -1
    for c0 in range(0, L, 512):
        model(kv, toks[:, c0:c0 + 512], pos[:, c0:c0 + 512],
              logits_mode="none")

    a, b_, c_ = kv.clone(), kv.clone(), kv.clone()
    del kv
    vt = torch.randint(3, llm.vocab_size, (S, Tq), generator=g).to(dev)
    # one 8-slot paged decode forward reads nothing back to the host
    nxt = without_sync("spec_full_width 8-slot paged decode forward",
                       lambda: model(c_, vt[:, :1], c_.pos.long()[:, None],
                                     logits_mode="argmax"))
    if nxt.shape != (S,) or not ((nxt >= 0) & (nxt < llm.vocab_size)).all():
        raise AssertionError(f"paged decode forward tokens {nxt.tolist()}")
    del c_
    vpos = a.pos.long()[:, None] + torch.arange(Tq, device=dev)[None]
    inline = model(a, vt, vpos, logits_mode="all")
    blocks = []
    commit = PagedKVCache.commit

    def keep(self, bl, index):
        blocks.extend(bl)
        return commit(self, bl, index)

    with mock.patch.object(PagedKVCache, "commit", keep):
        deferred, _ = counted("deferred verify",
                              ("flash_decode_paged_state",),
                              lambda: without_sync(
                                  "spec_full_width deferred paged verify",
                                  lambda: model(b_, vt, vpos,
                                                logits_mode="all",
                                                kv_update="deferred")))
    gap = near_tie_agree("spec_full_width deferred verify", deferred, inline)
    for name in ("k", "v", "k_scale", "v_scale"):
        if not torch.equal(getattr(a, name)[0], getattr(b_, name)[0]):
            raise AssertionError(f"deferred commit: layer 0 {name} differs "
                                 f"from the inline route's")
    pages, offs = a.locate(vpos)
    s_idx, t_idx = (pages < a.n_pages).nonzero(as_tuple=True)
    pages, offs = pages[s_idx, t_idx], offs[s_idx, t_idx]
    codes_differ = 0
    for layer, (kq, ks, vq, vs) in enumerate(blocks):
        for name, val in (("k", kq), ("k_scale", ks), ("v", vq),
                          ("v_scale", vs)):
            got = getattr(b_, name)[layer][pages, :, offs]
            if not torch.equal(got, val[s_idx, t_idx]):
                raise AssertionError(f"deferred commit: layer {layer} "
                                     f"{name} is not the block it kept")
            if name in ("k", "v"):
                codes_differ += int((got != getattr(a, name)[layer][
                    pages, :, offs]).sum())
    out["deferred_verify"] = dict(
        slots=S, rows=Tq, committed=lens, logit_gap=gap,
        paged_decode_and_verify_sync_free=True,
        int8_codes_differing_from_inline=codes_differ,
        layers=len(blocks))
    del a, b_, inline, deferred, blocks
    torch.cuda.empty_cache()
    out.update(launches=counted.launches, card=card_line())
    return out, counted.launches


def phase_tree_full_width(dev: torch.device, cfg, model) -> tuple[dict, dict]:
    """Token-tree speculation on llama-8b Q4_K (random weights: acceptance
    is reported, not held), a 512-token prompt:
      (a) DeviceTreeEngine with the [2, 1, 1] tree and a 4-layer
          self-draft (the fused layer chain; the draft levels and the
          verify through flash-decode's tree mode), 64 greedy tokens,
          each tree step a replayed graph, against its eager twin (a new
          engine, every step eager): the same tokens, both caches bit for
          bit, the same launch counts; a second (steady) call of each;
          the tokens against InferenceEngine.generate's (near-tie rule);
          one more replayed block under set_sync_debug_mode("error");
      (b) the host SpeculativeEngine with a llama-1b Q4_K draft, 16
          greedy tokens, against generate's (min_prob 0: at the default
          0.2 a random model's flat draft grows no tree).
    Returns the phase's line and each path's launch counts."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.speculative.device_tree import (
        DeviceTreeEngine, TreeTemplate, tree_spec_scan)
    from powerserve_tpu_torch.speculative.engine import (SpecStats,
                                                         SpeculativeEngine)
    from powerserve_tpu_torch.speculative.tree import SpeculativeConfig
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    llm = cfg.llm
    n_prompt, n_new, max_seq = 512, 64, 2048
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,),
                           generator=g).tolist()
    hp = HyperParams(max_slots=1, max_seq_len=max_seq, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    counted = Counted()
    want, plain_s = counted("plain generate", ("qmatmul", "fused_head"),
                            lambda: list(engine.generate(prompt, n_new)))
    tpl = TreeTemplate.from_widths([2, 1, 1])
    out: dict = {"phase": "tree_full_width", "tree": "2,1,1",
                 "nodes": tpl.n_nodes, "prompt_tokens": n_prompt,
                 "new_tokens": n_new, "plain_decode_tok_s": n_new / plain_s}
    need = TREE_NEED
    runs, engines = {}, {}
    label = "device_tree_self_draft_4"
    for path in (label, f"{label} eager"):
        eng = engines[path] = DeviceTreeEngine(
            model, cfg, self_draft_layers=4, template=tpl, block_steps=8,
            max_seq=max_seq, prefill_chunk=n_prompt, device=dev)
        runs[path] = []
        with (eager_steps() if path.endswith("eager")
              else contextlib.nullcontext()):
            for again in (False, True):  # the second call steady
                stats = SpecStats()
                got, secs = counted(path + " again" * again, need,
                                    lambda: list(eng.generate(
                                        prompt, n_new, stats=stats)))
                if len(got) != n_new:
                    raise AssertionError(f"{path}: {len(got)} tokens")
                runs[path].append((got, stats, secs))
    rep, twin = engines[label], engines[f"{label} eager"]
    got, stats, secs = runs[label][0]
    if {tuple(r[0]) for rs in runs.values() for r in rs} != {tuple(got)}:
        raise AssertionError(f"{label}: replayed tree steps {got} != the "
                             f"eager twin's or the second call's")
    same_launches(label, counted.launches, label, f"{label} eager")
    same_cache_bits(f"{label} target", rep.t_kv, twin.t_kv)
    same_cache_bits(f"{label} draft", rep.d_kv, twin.d_kv)
    graphs = graph_stats(graphs_of(rep.t_kv))
    without_sync(f"tree_full_width {label} replayed tree step",
                 lambda: tree_spec_scan(rep.target, rep.draft, rep.t_kv,
                                        rep.d_kv, rep._root, 8, tpl))
    tok_s = lambda r: n_new / (r[1].decode_ms / 1e3)  # noqa: E731
    out[label] = dict(
        accept_rate=stats.accept_rate, tokens_per_step=stats.tokens_per_step,
        steps=stats.steps, decode_tok_s=tok_s(runs[label][0]),
        decode_again_tok_s=tok_s(runs[label][1]),
        eager_decode_tok_s=tok_s(runs[f"{label} eager"][0]),
        eager_decode_again_tok_s=tok_s(runs[f"{label} eager"][1]),
        wall_s=secs, graphs=graphs, replay_equals_eager=True,
        cache_bits_equal=True, replayed_tree_step_sync_free=True,
        vs_generate_near_tie=agree(f"tree_full_width {label}", got, want,
                                   engine, prompt))
    del rep, twin, engines
    torch.cuda.empty_cache()

    # (b) the host-grown tree with a separate draft
    d_cfg, d_model = make_device_params("llama-1b", "q4_k", seed=1,
                                        device=dev)
    n_host = 16
    spec_cfg = SpeculativeConfig(min_prob=0.0)
    host = SpeculativeEngine(model, cfg, d_model, d_cfg, spec_cfg,
                             max_seq=max_seq, prefill_chunk=n_prompt,
                             device=dev)
    stats = SpecStats()
    got, secs = counted("host_tree_llama_1b", ("qmatmul", "fused_head",
                                               "flash_decode_tree"),
                        lambda: list(host.generate(prompt, n_host,
                                                   stats=stats)))
    out["host_tree_llama_1b"] = dict(
        draft_batch_size=spec_cfg.draft_batch_size, min_prob=0.0,
        tokens=len(got), steps=stats.steps, drafted=stats.drafted,
        accept_rate=stats.accept_rate,
        tokens_per_step=stats.tokens_per_step,
        decode_tok_s=len(got) / (stats.decode_ms / 1e3), wall_s=secs,
        vs_generate_near_tie=agree("tree_full_width host tree", got,
                                   want[:len(got)], engine, prompt))
    if len(got) != n_host:
        raise AssertionError(f"host tree: {len(got)} tokens")
    del host, d_model, engine
    torch.cuda.empty_cache()
    out.update(launches=counted.launches, card=card_line())
    return out, counted.launches


EAGLE_NEED = ("fused_concat2", "fused_x", "fused_norm", "fused_glu",
              "fused_x_argmax", "fused_head", "qmatmul", "flash_decode",
              "flash_prefill")
EAGLE_TREE_NEED = ("fused_concat2", "fused_x", "fused_norm", "fused_glu",
                   "fused_head", "qmatmul", "flash_decode_tree")


def phase_eagle_full_width(dev: torch.device, cfg, model,
                           head_dir: str) -> tuple[dict, dict]:
    """EAGLE speculation on llama-8b Q4_K (random weights: acceptance is
    reported, not held, except for the exact replica):
      (a) the head: a random EAGLE-1 head at the widths of the public
          EAGLE-LLaMA3-Instruct-8B head (one layer of 4096, FFN 14336,
          32/8 heads, rope base 500000; fc 8192 -> 4096 with a bias; no
          attn_norm on layer 0; Q8_0; the target's embedding and
          lm_head), written to head_dir by tools/synthetic.py's
          make_eagle_gguf from seed 4 and read by load_eagle_gguf, as
          `run --draft <head_dir>` and the server's "model+<head_dir>"
          read it;
      (b) EagleChainEngine, k = 4, a 512-token prompt and 64 greedy
          tokens, each step a replayed graph, a first and a steady call,
          against its eager twin (a new engine, every step eager: the
          same tokens, both caches bit for bit, the same launch counts)
          and against InferenceEngine.generate's tokens (near-tie
          rule); one more replayed block under set_sync_debug_mode
          ("error");
      (c) the same with the [2, 1, 1] tree (`run --spec-engine
          device-tree --spec-tree 2,1,1 --draft <head_dir>`'s engine);
      (d) full acceptance: the exact-replica head (fc = [I; 0] in Q8_0,
          the target's layer 0, final norm and lm_head) over a 1-layer
          target of llama-8b's widths (the model's first layer), k = 4:
          every draft accepted (k + 1 tokens a step, but for the last
          step cut at 64 tokens), the tokens those of that target's
          generate (near-tie rule).
    Returns the phase's line and each path's launch counts."""
    from powerserve_tpu_torch.core.config import HyperParams, ModelConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.models.loader import load_eagle_gguf
    from powerserve_tpu_torch.speculative.chain import self_draft_model
    from powerserve_tpu_torch.speculative.device_tree import TreeTemplate
    from powerserve_tpu_torch.speculative.eagle import (EagleChainEngine,
                                                        eagle_spec_scan,
                                                        replica_head)
    from powerserve_tpu_torch.speculative.engine import SpecStats
    from powerserve_tpu_torch.tools.synthetic import make_eagle_gguf

    llm = cfg.llm
    n_prompt, n_new, max_seq, k = 512, 64, 2048, 4
    t0 = time.perf_counter()
    make_eagle_gguf(head_dir, "llama-8b", GGMLType.Q8_0, seed=4)
    t1 = time.perf_counter()
    e_llm, head = load_eagle_gguf(head_dir, model, llm, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if head.embed is not model.embed or head.lm_head is not model.lm_head:
        raise AssertionError("the head holds copies of the target's tables")
    own = [head.fc, head.layers[0]] + ([head.fc_bias]
                                       if head.fc_bias is not None else [])
    head_gb = sum(t.numel() * t.element_size() for o in own
                  for t in ([o] if isinstance(o, torch.Tensor)
                            else list(o.buffers()))) / 1e9
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,),
                           generator=g).tolist()
    hp = HyperParams(max_slots=1, max_seq_len=max_seq, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    counted = Counted()
    want, _ = counted("plain generate", ("qmatmul", "fused_head"),
                      lambda: list(engine.generate(prompt, n_new)))
    plain = GenerationStats()  # a second, steady call
    engine.reset()
    list(engine.generate(prompt, n_new, stats=plain))
    out: dict = {"phase": "eagle_full_width", "k": k,
                 "prompt_tokens": n_prompt, "new_tokens": n_new,
                 "plain_decode_tok_s": plain.decode_speed,
                 "head": dict(layers=e_llm.n_layers, dim=e_llm.dim,
                              ffn=e_llm.hidden_dim, heads=e_llm.n_heads,
                              kv_heads=e_llm.n_kv_heads, quant="q8_0",
                              input_norm=head.input_norm,
                              fc_bias=head.fc_bias is not None,
                              own_gb=head_gb, write_s=t1 - t0,
                              load_s=t2 - t1)}

    def eagle_run(label, need, template=None, target=model, tcfg=cfg,
                  hd=head, reference=(want, engine)):
        """EagleChainEngine.generate replayed (a first and a steady call),
        then its eager twin: the same tokens, both caches bit for bit and
        the same launch counts."""
        runs, engines = {}, {}
        for path in (label, f"{label} eager"):
            eng = engines[path] = EagleChainEngine(
                target, tcfg, hd, k=k, block_steps=8, max_seq=max_seq,
                prefill_chunk=n_prompt, template=template, device=dev)
            runs[path] = []
            eager = path.endswith("eager")
            with eager_steps() if eager else contextlib.nullcontext():
                for again in ((False,) if eager else (False, True)):
                    stats = SpecStats()
                    got, secs = counted(path + " again" * again, need,
                                        lambda: list(eng.generate(
                                            prompt, n_new, stats=stats)))
                    if len(got) != n_new:
                        raise AssertionError(f"{path}: {len(got)} tokens")
                    runs[path].append((got, stats, secs))
        rep, twin = engines[label], engines[f"{label} eager"]
        got, stats, secs = runs[label][0]
        if {tuple(r[0]) for rs in runs.values() for r in rs} != {tuple(got)}:
            raise AssertionError(f"{label}: replayed steps {got} != the "
                                 f"eager twin's or the second call's")
        same_launches(label, counted.launches, label, f"{label} eager")
        same_cache_bits(f"{label} target", rep.t_kv, twin.t_kv)
        same_cache_bits(f"{label} head", rep.d_kv, twin.d_kv)
        tok_s = lambda r: n_new / (r[1].decode_ms / 1e3)  # noqa: E731
        steady = runs[label][1][1]
        res = dict(accept_rate=stats.accept_rate,
                   tokens_per_step=stats.tokens_per_step, steps=stats.steps,
                   steady_step_ms=steady.decode_ms / steady.steps,
                   decode_tok_s=tok_s(runs[label][0]),
                   decode_again_tok_s=tok_s(runs[label][1]),
                   eager_decode_tok_s=tok_s(runs[f"{label} eager"][0]),
                   wall_s=secs, graphs=graph_stats(graphs_of(rep.t_kv)),
                   replay_equals_eager=True, cache_bits_equal=True,
                   vs_generate_near_tie=agree(f"eagle_full_width {label}",
                                              got, reference[0],
                                              reference[1], prompt))
        return res, rep

    # (b) the chain, (c) the tree
    out["chain"], rep = eagle_run("chain", EAGLE_NEED)
    without_sync("eagle_full_width replayed EAGLE chain step",
                 lambda: eagle_spec_scan(rep.target, rep.draft, rep.t_kv,
                                         rep.d_kv, rep._root,
                                         rep._root_feat, 8, k))
    out["chain"]["replayed_step_sync_free"] = True
    del rep
    out["tree"], _ = eagle_run("tree", EAGLE_TREE_NEED,
                               TreeTemplate.from_widths([2, 1, 1]))
    out["tree"]["tree"] = "2,1,1"
    del head
    torch.cuda.empty_cache()

    # (d) the exact replica over a 1-layer target
    target = self_draft_model(model, 1)
    tcfg = ModelConfig(arch=cfg.arch, llm=target.llm)
    replica = replica_head(target)
    one = InferenceEngine(target, tcfg, hp, device=dev)
    want1, _ = counted("replica plain generate", ("qmatmul",),
                       lambda: list(one.generate(prompt, n_new)))
    plain1 = GenerationStats()
    one.reset()
    list(one.generate(prompt, n_new, stats=plain1))
    # the replica's head has the target's final norm: the norm head
    out["replica"], _ = eagle_run("replica", tuple(
        n for n in EAGLE_NEED if n != "fused_x_argmax"), target=target,
                                  tcfg=tcfg, hd=replica,
                                  reference=(want1, one))
    out["replica"].update(target_layers=1,
                          plain_decode_tok_s=plain1.decode_speed)
    if out["replica"]["accept_rate"] != 1.0:
        raise AssertionError(f"the exact-replica head accepted "
                             f"{out['replica']['accept_rate']} of its "
                             f"drafts: {out['replica']}")
    del replica, target, one, engine
    torch.cuda.empty_cache()
    out.update(launches=counted.launches, card=card_line())
    return out, counted.launches


VLM_NEED = ("qmatmul", "fused_head", "flash_prefill", "flash_decode")
VLM_PRESET = "internvl2.5-4b"


def vlm_png(seed: int, width: int, height: int) -> tuple:
    """A PNG this script writes itself (no PIL): gradients plus noise,
    its rows filtered by all five PNG filters in turn. (bytes, pixels)."""
    import numpy as np

    from powerserve_tpu_torch.core.image import encode_png

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([x * 255 // width, y * 255 // height,
                    (x + y) * 255 // (width + height)], axis=-1)
    img = (img + rng.integers(0, 48, img.shape)).clip(0, 255).astype(
        np.uint8)
    return encode_png(img, (0, 1, 2, 3, 4)), img


def mm_agree(label: str, got: list[int], want: list[int], vlm, ids: list[int],
             px) -> float | None:
    """got equals want, or first differs where the multimodal prefill of
    ids + want[:i] (the images' rows at the image-context ids, on the
    kernels) has a top-2 logit gap < NEAR_TIE; returns that gap."""
    from powerserve_tpu_torch.kv.cache import KVCache

    i = first_divergence(got, want)
    if i < 0:
        return None
    llm = vlm.cfg.llm
    kv = KVCache.create(llm.n_layers, 1, 2048, llm.n_kv_heads,
                        llm.head_size, vlm.device)
    logits = vlm.prefill_multimodal(kv, list(ids) + want[:i], px)
    top2 = logits[0].float().topk(2).values
    gap = float(top2[0] - top2[1])
    if not gap < NEAR_TIE:
        raise AssertionError(f"{label}: {got} vs {want} differ at {i} with "
                             f"a top-2 gap of {gap}")
    return gap


def phase_vlm_full_width(dev: torch.device) -> tuple[dict, dict]:
    """InternVL2.5-4B's widths (InternViT-300M-448px: 24 layers of 1024,
    16 heads, MLP 4096; the projector 4096 -> 2048 -> 2048; Qwen2.5-3B
    Q4_K, 36 layers), random weights: an 896 x 448 PNG written and
    decoded here (2 tiles + the thumbnail = 768 image tokens) and a
    32-token text prompt through VLMEngine, 64 greedy tokens, twice (the
    second steady). The multimodal prefill's logits and one decode step on
    the kernels against the plain twins on the card (near-tie rule), the
    prefill under set_sync_debug_mode("error"); the tower on the card
    against the CPU on one tile through its first 4 layers. First, the
    committed 896 x 448 progressive 4:2:0 JPEG decoded (jpeg_fixture: its
    pixels' sha256 Pillow's, the decode's host ms)."""
    import numpy as np

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.core.image import decode_image
    from powerserve_tpu_torch.engine.generator import GenerationStats
    from powerserve_tpu_torch.engine.vlm import VLMEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.vit import (LAYER_FIELDS, TOP_FIELDS,
                                                 encode_images,
                                                 make_vision_params)
    from powerserve_tpu_torch.tools.bench_params import make_device_internvl

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vlm = make_device_internvl(VLM_PRESET, "q4_k", seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    llm, vp = vlm.cfg.llm, vlm.vision
    tile = vlm.image_size
    png, pixels = vlm_png(0, 2 * tile, tile)
    t0 = time.perf_counter()
    img = decode_image(png)
    decode_s = time.perf_counter() - t0
    if not np.array_equal(img, pixels):
        raise AssertionError("the PNG decoder did not give back the pixels")
    eng = VLMEngine(vlm, HyperParams(max_seq_len=2048), device=dev)
    t0 = time.perf_counter()
    px = eng.pixel_values([img])
    preprocess_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(2)
    text = torch.randint(3, vlm.image_token_id, (31,), generator=g).tolist()
    prompt = [1] + text[:8] + [vlm.image_token_id] + text[8:]
    ids = vlm.expand_image_tokens(prompt, px.shape[0])
    n_img = ids.count(vlm.image_token_id)
    if px.shape != (3, 3, tile, tile) or n_img != 3 * vlm.tokens_per_tile:
        raise AssertionError(f"tiles {px.shape}, image tokens {n_img}")
    jpeg = jpeg_fixture()["info"]
    out: dict = {"phase": "vlm_full_width", "preset": VLM_PRESET, "jpeg": jpeg,
                 "vision_layers": len(vp.layers), "vision_dim": vp.dim,
                 "text_layers": llm.n_layers, "text_dim": llm.dim,
                 "vocab": llm.vocab_size, "build_s": build_s,
                 "png_bytes": len(png), "host_png_decode_ms": decode_s * 1e3,
                 "host_preprocess_ms": preprocess_s * 1e3,
                 "tiles": px.shape[0],
                 "image_tokens": n_img, "prompt_tokens": len(ids)}
    px_dev = torch.from_numpy(px).to(dev)
    ids_dev = torch.tensor(ids, device=dev)

    # the tower + projector: CUDA-event ms over the 3 tiles, warm
    times = []
    encode_images(vp, px_dev)
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        encode_images(vp, px_dev)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["vision_ms_per_tile"] = statistics.median(times) / px.shape[0]

    # the tower on the card against the CPU: one tile, its first 4 layers
    def cut(device):
        return make_vision_params(
            {n: getattr(vp, n).to(device) for n in TOP_FIELDS},
            [{f: (None if getattr(lw, f) is None
                  else getattr(lw, f).float().to(device))
              for f in LAYER_FIELDS} for lw in vp.layers[:4]],
            vp.patch_size, vp.n_heads, vp.eps, vp.downsample, device)

    t0 = time.perf_counter()
    ref = encode_images(cut("cpu"), px_dev[:1].cpu())
    cpu_s = time.perf_counter() - t0
    got = encode_images(cut(dev), px_dev[:1])
    err = logit_gap(got, ref)
    if not torch.isfinite(got).all() or not err <= VISION_REL:
        raise AssertionError(f"vision tower on the card vs the CPU: {err} "
                             f"of the range (tolerance {VISION_REL})")
    out["vision_vs_cpu"] = {"tiles": 1, "layers": min(4, len(vp.layers)),
                            "rel_err": err,
                            "tolerance": VISION_REL, "cpu_s": cpu_s}

    # the multimodal prefill (tower, overlay, forward) under sync-error
    # mode, against the plain twins; then one decode step each way
    def fresh():
        return KVCache.create(llm.n_layers, 1, 2048, llm.n_kv_heads,
                              llm.head_size, dev)

    counted = Counted()
    kv = fresh()
    logits, _ = counted(
        "mm_prefill", ("qmatmul", "fused_head", "flash_prefill"),
        lambda: without_sync("vlm_full_width mm prefill",
                             lambda: vlm.prefill_multimodal(kv, ids_dev,
                                                            px_dev)))
    kv2 = fresh()
    _, prefill_s = counted("mm_prefill again", ("qmatmul", "flash_prefill"),
                           lambda: vlm.prefill_multimodal(kv2, ids_dev,
                                                          px_dev))
    del kv2
    twin_kv = fresh()
    logits_twin = step_on(plain_routes(), lambda: vlm.prefill_multimodal(
        twin_kv, ids_dev, px_dev))
    first = logits.argmax(dim=-1)

    def step(routes, c):
        return step_on(routes, lambda: vlm.llm(
            c, first[:, None], c.pos.long()[:, None], logits_mode="last"))

    out["prefill_logit_gap"] = near_tie_agree("vlm prefill", logits,
                                              logits_twin)
    # one decode step from the same cache on the kernels and the twins
    out["decode_step_logit_gap"] = near_tie_agree(
        "vlm decode step", step({}, kv.clone()),
        step(plain_routes(), kv.clone()))
    out["prefill_sync_free"] = True
    out["mm_prefill_tok_s"] = len(ids) / prefill_s
    del kv, twin_kv, logits, logits_twin

    # VLMEngine: the PNG's pixels, 64 greedy tokens, twice
    runs = []
    for again in (False, True):
        stats = GenerationStats()
        toks, _ = counted("vlm_generate" + " again" * again, VLM_NEED,
                          lambda: list(eng.generate(prompt, [img], 64,
                                                    stats=stats)))
        runs.append((toks, stats))
    if runs[0][0] != runs[1][0] or len(runs[0][0]) != 64:
        raise AssertionError(f"VLMEngine: {runs[0][0]} != {runs[1][0]}")
    if not all(0 <= t < llm.vocab_size for t in runs[0][0]):
        raise AssertionError(f"VLMEngine tokens out of range: {runs[0][0]}")
    for again, (_, st) in enumerate(runs):
        key = "_again" * again
        out[f"generate_prefill_tok_s{key}"] = st.prefill_speed
        out[f"generate_decode_tok_s{key}"] = st.decode_speed
    out["kernel_launches"] = {k: counted.launches["vlm_generate"][k]
                              for k in VLM_NEED}
    out.update(launches=counted.launches, graphs=graph_stats(eng.engine.graphs),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               card=card_line())
    return out, dict(vlm=vlm, engine=eng, n_img=n_img)


def phase_serve_vlm_full_width(dev: torch.device, ref: dict) -> dict:
    """vlm_full_width's model behind the HTTP server: serve_full_width's 8
    slots and pool (128 pages of 64), 4 chat requests each with an 896 x
    448 PNG (768 image tokens) and 4 text completions of 256-640 tokens
    at once, 64 greedy tokens each, served twice (a fresh server each
    time; the first pays the process's first serving of this model): every
    request ends "length", the paged and prefill kernels launch, the
    second serving's tokens are the first's, every image request's tokens
    are VLMEngine's (near-tie rule); then image request 0 alone must get
    its batched tokens, the same request to "model+self:4" the plain
    ones, and the JPEG fixture as data:image/jpeg, alone, the tokens of
    the PNG of its decoded pixels. Generated tok/s and TTFT p50/p90 of each serving (the
    scheduler's, from the submit, which follows the request's image
    encode on the scheduler thread: each encode job's ms, from its call
    to its future's result (the wait for the thread and the launches;
    the device work runs on behind it), are reported apart)."""
    import base64
    import random

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    vlm, eng, n_img = ref["vlm"], ref["engine"], ref["n_img"]
    tile = vlm.image_size
    n_new = 64
    tok = synthetic_tokenizer(vlm.cfg.llm.vocab_size)
    images = [vlm_png(seed, 2 * tile, tile) for seed in range(4)]
    questions = ["describe the picture", "what colors do you see",
                 "is there any text here", "count the stripes please"]
    # each question's prompt ids; the image's rows lead them (no
    # placeholder in the text)
    asked = {tuple(tok.tokenize(tok.apply_chat_template(
        [{"role": "user", "content": q}]))): k
        for k, q in enumerate(questions)}
    rng = random.Random(1)
    texts = ["".join(rng.choice("abcdefghijklmnopqrsuvwxyz")
                     for _ in range(n - 4)) for n in (256, 384, 512, 640)]
    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=128, page_size=64)
    depth = min(4, vlm.cfg.llm.n_layers - 1)
    spec_name = f"model+self:{depth}"

    def chat(port, k, model="model"):
        url = ("data:image/png;base64,"
               + base64.b64encode(images[k][0]).decode())
        return http_call(port, "POST", "/v1/chat/completions", {
            "model": model, "max_tokens": n_new, "temperature": 0,
            "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text", "text": questions[k]}]}]})

    encode_ms: list[float] = []

    def timed_jobs(sched) -> None:
        """Each job's ms on `sched` (the image encodes), from its call to
        its future's result."""
        call = sched.call

        def timed_call(fn):
            t0 = time.perf_counter()
            fut = call(fn)
            fut.add_done_callback(lambda _: encode_ms.append(
                (time.perf_counter() - t0) * 1e3))
            return fut

        sched.call = timed_call

    def serve_once(label: str, alone: dict | None) -> dict:
        """The traffic on a fresh server; with `alone` (a dict to fill),
        then image request 0 alone and on the speculative name."""
        encode_ms.clear()
        with tempfile.TemporaryDirectory() as tmp:
            ctx = ServerContext(tmp, "model", hp, dev)
            t0 = time.perf_counter()
            # the image worker processes start with the model, ready when
            # register returns (a server loads its models before traffic)
            timed_jobs(ctx.register("model", vlm.llm, vlm.cfg, tok,
                                    vlm=vlm).scheduler)
            workers_s = time.perf_counter() - t0
            server = serving(ctx)
            port = server.server_address[1]
            try:
                calls = [lambda k=k: chat(port, k) for k in range(4)]
                calls += [lambda t=t: http_call(
                    port, "POST", "/v1/completions", {
                        "model": "model", "prompt": t, "max_tokens": n_new,
                        "temperature": 0}) for t in texts]
                with ServeRecorder() as rec:
                    cuda_lib.reset_launch_counts()
                    t0 = time.perf_counter()
                    replies = concurrently(calls)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = cuda_lib.launch_counts()
                rec.check(label)
                for status, data in replies:
                    if status != 200 or json.loads(data)["choices"][0][
                            "finish_reason"] != "length":
                        raise AssertionError(f"{label}: {status} "
                                             f"{data[:200]}")
                missing = [k for k in SERVE_NEED if not launches[k]]
                if missing:
                    raise AssertionError(f"{label} did not launch "
                                         f"{missing}: {launches}")
                metrics = metrics_of(port)
                tokens = rec.tokens()
                lengths = sorted(len(v) for v in tokens.values())
                if lengths != [n_new] * 8:
                    raise AssertionError(f"{label}: token counts {lengths}")
                run = dict(tokens=tokens, wall=wall, metrics=metrics,
                           launches=launches, encode_ms=list(encode_ms),
                           workers_s=workers_s)
                if alone is None:
                    return run
                p0 = next(p for p in tokens
                          if p.count(vlm.image_token_id) == n_img
                          and asked[p[n_img:]] == 0)
                px0 = eng.pixel_values([images[0][1]])
                for key, model_name in (("alone", "model"),
                                        (f"self_draft_{depth}", spec_name)):
                    with ServeRecorder() as rec2:
                        status, data = chat(port, 0, model_name)
                    rec2.check(f"{label} {key}")
                    if status != 200:
                        raise AssertionError(f"{key}: {status} {data[:200]}")
                    got = rec2.tokens()[p0]
                    alone[key] = {"exact": got == tokens[p0],
                                  "near_tie": mm_agree(
                                      f"{key} vs batched", got, tokens[p0],
                                      vlm, list(p0), px0)}
                alone[f"self_draft_{depth}"]["spec_tokens_per_step"] = \
                    ctx.get(spec_name).scheduler.metrics().get(
                        "spec_tokens_per_step")
                # the JPEG fixture as data:image/jpeg, then the PNG of its
                # decoded pixels, each alone: the same tokens
                fixture = jpeg_fixture()
                kinds = {}
                for kind, url in image_urls(fixture).items():
                    with ServeRecorder() as rec3:
                        status, data = chat_image(port, url, questions[1],
                                                  n_new)
                    rec3.check(f"{label} {kind}")
                    if status != 200:
                        raise AssertionError(f"{kind}: {status} "
                                             f"{data[:200]}")
                    kinds[kind] = rec3.tokens()
                if kinds["jpeg"] != kinds["png"]:
                    raise AssertionError(f"the JPEG's reply {kinds['jpeg']} "
                                         f"!= its pixels' PNG's "
                                         f"{kinds['png']}")
                alone["jpeg_equals_png"] = dict(
                    equal=True, jpeg=fixture["info"],
                    tokens=len(next(iter(kinds["jpeg"].values()))))
                return run
            finally:
                server.shutdown()
                server.server_close()
                ctx.close()

    res: dict = {}
    first = serve_once("serve_vlm_full_width first", None)
    run = serve_once("serve_vlm_full_width", res)
    tokens = run["tokens"]
    image_prompts = [p for p in tokens if p.count(vlm.image_token_id) == n_img]
    if len(image_prompts) != 4:
        raise AssertionError(f"{len(image_prompts)} image prompts")
    gaps, again = [], []
    for p in tokens:
        # the first serving against the second (near-tie rule)
        if p in image_prompts:
            k = asked[tuple(p[n_img:])]
            px = eng.pixel_values([images[k][1]])
            again.append(mm_agree(f"first vs second serving (image {k})",
                                  first["tokens"][p], tokens[p], vlm,
                                  list(p), px))
            # against VLMEngine on its prompt and image
            want = list(eng.generate(list(p[n_img:]), [images[k][1]],
                                     n_new))
            gaps.append(mm_agree(f"serve vs VLMEngine (image {k})",
                                 tokens[p], want, vlm, list(p), px))
        elif first["tokens"][p] != tokens[p]:
            raise AssertionError(f"a text request's tokens differ between "
                                 f"two servings: {tokens[p]} vs "
                                 f"{first['tokens'][p]}")

    def rates(r):
        m = r["metrics"]
        return {"wall_s": r["wall"], "generated_tok_s": 8 * n_new / r["wall"],
                "ttft_p50_s": m["ttft_seconds_p50"],
                "ttft_p90_s": m["ttft_seconds_p90"],
                "latency_p50_s": m["request_latency_seconds_p50"],
                "image_encode_job_ms": r["encode_ms"][:4],
                "image_workers_start_s": r["workers_s"]}

    metrics = run["metrics"]
    return {"phase": "serve_vlm_full_width", "preset": VLM_PRESET,
            "slots": 8, "pool_pages": 128, "page": 64,
            "image_requests": 4, "text_requests": 4, "new_tokens": n_new,
            **rates(run), "first_serving": rates(first),
            "preemptions": metrics["paged_preemptions_total"],
            "vs_vlm_engine_near_ties": [g for g in gaps if g is not None],
            "vs_first_serving_near_ties": [g for g in again
                                           if g is not None],
            "image_request_0": res,
            "kernel_launches": {k: run["launches"][k] for k in SERVE_NEED},
            "launches": run["launches"], "card": card_line()}


# the model and shapes of the tensor-parallel phases: llama-8b at tp = 2,
# each rank 16/4 heads, FFN 7168, vocab 64128
TP = 2
TP_NEED = ("qmatmul", "fused_head", "flash_prefill", "flash_decode")


def tp_backend() -> tuple[str, str]:
    """(backend, how the ranks run): NCCL with a card a rank where there
    are two cards, else gloo with both ranks on the one card."""
    if torch.cuda.device_count() >= TP:
        return "nccl", "two ranks on two cards over nccl"
    return "gloo", ("two ranks on one card over gloo: a check of function, "
                    "not of speed")


def phase_tp_kernels(dev: torch.device, read_flush: bool = False) -> dict:
    """Each kernel at llama-8b's tp = 2 local shapes against its twin on
    the card, with CUDA-event times and bounds (as the kernels phase):
    the GEMV (M = 1, 8) and the prefill GEMM (M = 512) at QKV 4096 ->
    3072, wo 2048 -> 4096, gate|up 4096 -> 14336 and down 7168 -> 4096
    (pack group 1792, new to the kernels); the fused head 4096 -> 64128
    with and without its argmax; flash-decode (S = 1 and 8, T = 1024) and
    flash-prefill (S = 1, 512 rows from 0 of 2048) at 16/4 heads, and
    flash-decode's tree mode at an EAGLE [2, 1, 1] tree's verify (S = 1,
    7 nodes over 1000 committed positions) at 16/4 heads. Every GEMM and
    attention case twice, bit for bit."""
    from powerserve_tpu_torch.ops.flash_decode import (
        decode_visibility, flash_decode_cuda, flash_decode_quant_reference)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_cuda, flash_prefill_quant_reference, prefill_visibility)
    from powerserve_tpu_torch.ops.fused import (fused_linear_cuda,
                                                fused_linear_reference,
                                                norm_rounding_slack,
                                                prologue_reference)
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_cuda,
                                                  qmatmul_reference)
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    timer = Timer(dev, read_flush)
    g = torch.Generator(device=dev)
    g.manual_seed(14)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def held(name, got, ref, rel_tol, slack=0.0, flips_of=None):
        """got within rel_tol of ref's largest value (+ slack); attention
        (flips_of = the value scales) lets 1 in 100 outputs exceed it by
        at most the bf16 flips of p * vs (the kernels phase's rule)."""
        err = (got.float() - ref.float()).abs()
        tol = rel_tol * max(1.0, ref.float().abs().max().item()) + slack
        flip = (0.0 if flips_of is None
                else 2.0 ** -8 * 127 * flips_of.float().abs().max().item())
        over = (err > tol).float().mean().item()
        if over > (1e-2 if flips_of is not None else 0.0) or \
                not (err <= tol + flip).all():
            raise AssertionError(f"{name}: max abs err {err.max().item()}, "
                                 f"{over} of outputs over {tol}")
        return err.max().item()

    def twice(name, fn):
        out = fn()
        if not torch.equal(out, fn()):
            raise AssertionError(f"{name}: two runs gave different bits")
        return out

    rows = []
    for proj, k, n in (("qkv", 4096, 3072), ("wo", 2048, 4096),
                       ("gate|up", 4096, 14336), ("down", 7168, 4096)):
        lin = _rand_qlinear(g, k, n, "q4_k", dev)
        for m in (1, 8, 512):
            x = randn(m, k, dtype=torch.bfloat16)
            name = f"tp qmatmul {proj} {m}x{k}x{n}"
            err = held(name, twice(name, lambda: qmatmul_cuda(x, lin)),
                       qmatmul_reference(x, lin), 1e-4)
            b, by = bound_ms(nbytes(x) + lin.nbytes() + m * n * 4,
                             2.0 * m * n * k)
            rows.append(dict(
                kernel="qmatmul", shape=proj, m=m, k=k, n=n,
                pack_group=lin.pack_group, max_abs_err=err,
                ms=timer(lambda: qmatmul_cuda(x, lin)),
                plain_ms=timer(lambda: qmatmul_reference(x, lin), reps=10),
                bound_ms=b, bound_by=by, library_ms=None))
        del lin
    head = _rand_qlinear(g, 4096, 64128, "q4_k", dev)
    nw = torch.rand(4096, generator=g, device=dev) + 0.5
    h = randn(1, 4096, dtype=torch.bfloat16) * 3
    err = held("tp fused head", fused_linear_cuda(head, "norm", [h], nw),
               fused_linear_reference(head, norm=(h, nw)), 1e-4,
               norm_rounding_slack(head, h, nw))
    tok = fused_linear_cuda(head, "norm", [h], nw, argmax=True)
    if not torch.equal(tok, fused_linear_reference(
            head, norm=(h, nw)).argmax(-1).to(torch.int32)):
        raise AssertionError("tp fused head: the argmax is not the twin's")
    xh = prologue_reference("norm", [h], nw)
    for argmax in (False, True):
        b, by = bound_ms(nbytes(h, nw) + head.nbytes()
                         + (4 if argmax else 64128 * 4), 2.0 * 64128 * 4096)
        rows.append(dict(
            kernel="fused_head", shape="head", m=1, k=4096, n=64128,
            argmax=argmax, max_abs_err=err,
            ms=timer(lambda: fused_linear_cuda(head, "norm", [h], nw,
                                               argmax=argmax)),
            gemv_ms=timer(lambda: qmatmul_cuda(xh, head)),
            plain_ms=timer(lambda: fused_linear_reference(
                head, norm=(h, nw), argmax=argmax), reps=10),
            bound_ms=b, bound_by=by, library_ms=None))
    del head

    H, Hkv, D = 32 // TP, 8 // TP, 128
    scale = 1.0 / D ** 0.5

    def cache(S, T):
        kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
                  for _ in range(2))
        return kq, ks, vq, vs

    def attn(kernel, shape, q, kv4, vis, fn, ref_fn, extra):
        name = f"tp {kernel} {shape}"
        err = held(name, twice(name, fn), ref_fn(), 1e-4, flips_of=kv4[3])
        S, Tq = q.shape[:2]
        b, by = bound_ms(2 * nbytes(q) + int(vis.any(dim=1).sum()) * Hkv
                         * (2 * D + 8) + extra, 4.0 * D * H * float(vis.sum()))
        qh = q.permute(0, 2, 1, 3).to(torch.bfloat16)
        kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(H // Hkv, dim=1)
                  for c, sc in ((kv4[0], kv4[1]), (kv4[2], kv4[3])))
        return dict(
            kernel=kernel, shape=shape, heads=f"{H}/{Hkv}", max_abs_err=err,
            ms=timer(fn), plain_ms=timer(ref_fn, reps=5), bound_ms=b,
            bound_by=by,
            library_ms=timer(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qh, kd, vd, attn_mask=vis[:, None])))

    for S in (1, 8):
        T = 1024
        q = randn(S, 1, H, D)
        kv4 = cache(S, T)
        mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
        mask[:, :T - 1] = True
        pos = torch.full((S, 1), T - 1, dtype=torch.int32, device=dev)
        args = (q, *kv4, mask, pos, scale)
        rows.append(attn("flash_decode", f"S={S} Tq=1 T={T}", q, kv4,
                         decode_visibility(mask, pos, 1),
                         lambda: flash_decode_cuda(*args),
                         lambda: flash_decode_quant_reference(*args),
                         nbytes(mask, pos)))
    q = randn(1, 512, H, D)
    kv4 = cache(1, 2048)
    mask = torch.zeros(1, 2048, dtype=torch.bool, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (q, *kv4, mask, start, scale)
    rows.append(attn("flash_prefill", "S=1 Tq=512 T=2048 start 0", q, kv4,
                     prefill_visibility(mask, start, 512)[..., :2048],
                     lambda: flash_prefill_cuda(*args),
                     lambda: flash_prefill_quant_reference(*args),
                     nbytes(mask, start)))
    # the tree mode at the local heads (an EAGLE [2, 1, 1] tree's verify
    # over the ranks: 7 nodes at c + i over 1000 committed positions)
    from powerserve_tpu_torch.ops.flash_decode import pack_intra

    parents = [-1, 0, 0, 1, 2, 3, 4]
    N = len(parents)
    anc = torch.zeros(N, N, dtype=torch.bool, device=dev)
    for i_ in range(N):
        j_ = i_
        while j_ >= 0:
            anc[i_, j_] = True
            j_ = parents[j_]
    bits = pack_intra(anc)
    T = 2048
    q = randn(1, N, H, D)
    kv4 = cache(1, T)
    mask = torch.arange(T, device=dev)[None, :] < 1000
    keys = (1000 + torch.arange(N, device=dev)[None, :]).to(torch.int32)
    args = (q, *kv4, mask, keys, scale)
    rows.append(attn("flash_decode_tree", f"S=1 Tq={N} T={T} verify", q,
                     kv4, decode_visibility(mask, keys, N, bits),
                     lambda: flash_decode_cuda(*args, bits=bits),
                     lambda: flash_decode_quant_reference(*args, bits=bits),
                     nbytes(mask, keys, bits)))
    torch.cuda.synchronize()
    return {"phase": "tp_kernels", "tp": TP,
            "flush": "read" if read_flush else "write", "rows": rows}


def tp_agree(label: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Logits over two ranks against the single-device forward on the
    same card: within TP_LOGIT_REL of the range, the same greedy token
    unless the single device's top-2 gap is < NEAR_TIE."""
    gap = logit_gap(got, ref)
    if not torch.isfinite(got).all() or not gap <= TP_LOGIT_REL:
        raise AssertionError(f"{label}: two ranks differ from one device by "
                             f"{gap} of the range")
    top2 = ref.reshape(-1, ref.shape[-1]).topk(2, dim=-1)
    flip = got.reshape(-1, got.shape[-1]).argmax(-1) != top2.indices[:, 0]
    if (flip & ((top2.values[:, 0] - top2.values[:, 1]) >= NEAR_TIE)).any():
        raise AssertionError(f"{label}: the greedy token is not one "
                             f"device's")
    return gap


def rank_counts(counts: list[dict], need: tuple, label: str) -> list[dict]:
    """Each rank's launches of the kernels in need; every rank must have
    launched each."""
    out = [{k: c[k] for k in need} for c in counts]
    for r, c in enumerate(out):
        missing = [k for k, n in c.items() if not n]
        if missing:
            raise AssertionError(f"{label}: rank {r} launched no {missing}")
    return out


def phase_tp_full_width(dev: torch.device, cfg, model) -> dict:
    """llama-8b Q4_K over two ranks (tp = 2, random weights from seed 0 on
    every rank): a 512-token prefill and one decode step held against the
    single-device forward `model` on the same card (TP_LOGIT_REL), then
    greedy decoding to 32 tokens against generate's (near-tie rule). The
    launch counts of every rank are zeroed before each path and read
    after it; the wall times are of a check of function when the ranks
    share a card."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.parallel.tp import (start_rank_group,
                                                  tp_decode_scan, tp_forward,
                                                  tp_prefill)

    llm = cfg.llm
    backend, how = tp_backend()
    n_prompt, n_tokens, max_seq = 512, 32, 2048
    g = torch.Generator(device="cpu")
    g.manual_seed(1)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    out: dict = {"phase": "tp_full_width", "tp": TP, "backend": backend,
                 "ranks": how}
    t0 = time.perf_counter()
    group = start_rank_group(TP, backend, dev)
    try:
        out["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, tm = group.preset("llama-8b", "q4_k", 0, TP)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        lw = tm.shard.model.layers[0]
        local = dict(qkv=tuple(lw.wqkv.q.shape), wo=lw.wo.in_features,
                     gate_up=lw.wgu.out_features, down=lw.w_down.in_features,
                     down_pack_group=lw.w_down.pack_group,
                     head=tm.shard.model.lm_head.out_features,
                     heads=(tm.shard.model.llm.n_heads,
                            tm.shard.model.llm.n_kv_heads))
        if (local["down"], local["down_pack_group"], local["head"],
                local["heads"]) != (7168, 1792, 64128, (16, 4)):
            raise AssertionError(f"tp shards: {local}")
        out["local_shapes"] = local
        kv1 = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                             llm.head_size, dev)
        kv2 = tm.create_cache(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                              llm.head_size)
        toks = prompt[None].to(dev)
        pos = torch.arange(n_prompt, device=dev)[None]
        want = model(kv1, toks, pos, logits_mode="last")
        counts = {}

        def timed(name, need, fn):
            group.launch_counts(reset=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out[f"{name}_wall_s"] = time.perf_counter() - t
            counts[name] = rank_counts(group.launch_counts(), need,
                                       f"tp {name}")
            return res

        got = timed("prefill", TP_NEED[:3], lambda: tp_prefill(
            tm, toks, pos, kv2))
        out["prefill_logit_gap"] = tp_agree("tp prefill", got, want)
        first = want.argmax(-1)
        dpos = torch.full((1, 1), n_prompt, device=dev)
        want_d = model(kv1, first[:, None], dpos, logits_mode="last")
        got_d = timed("decode_step", ("qmatmul", "fused_head",
                                      "flash_decode"),
                      lambda: tp_forward(tm, kv2, first[:, None], dpos,
                                         logits_mode="last"))
        out["decode_step_logit_gap"] = tp_agree("tp decode step", got_d,
                                                want_d)
        # greedy to 32 tokens over the ranks: the prefill's argmax, the
        # step's, then 30 decode steps (argmax heads reduced over ranks)
        scan = timed("decode_scan", ("qmatmul", "fused_head",
                                     "flash_decode"),
                     lambda: tp_decode_scan(tm, got_d.argmax(-1), kv2,
                                            n_tokens - 2))
        tp_tokens = ([int(got.argmax(-1)), int(got_d.argmax(-1))]
                     + scan[0].tolist())
        out["decode_tok_s"] = (n_tokens - 2) / out["decode_scan_wall_s"]
        hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=max_seq)
        hp.sampler.temperature = 0.0
        engine = InferenceEngine(model, cfg, hp, device=dev)
        plist = prompt.tolist()
        # generate prefills prompt[:-1] and decodes from the last token:
        # its first token is the prefill's argmax over the whole prompt
        ref = list(engine.generate(plist, n_tokens))
        out["near_tie_gap"] = agree("tp greedy vs generate", tp_tokens, ref,
                                    engine, plist)
        out["tokens_equal"] = tp_tokens == ref
        out["launches"] = counts
        out["rank_launches_decode_scan"] = counts["decode_scan"]
    finally:
        group.close()
    return out


def phase_serve_tp(dev: torch.device) -> dict:
    """The HTTP server over two ranks (tp = 2) on tiny Q8_0 and tiny-k
    Q4_K: the dense cache (plain and "model+self:1"), a paged pool that
    preempts (10 pages of 8), and tp = 2 x dp = 2 on a pool of 20 pages
    (10 a dp block, four ranks on the card), with serve_run's traffic;
    every request's greedy tokens the single-device server's (near-tie
    rule), no request in error, and each rank's launches."""
    from powerserve_tpu_torch.core.config import HyperParams, WorkspaceConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    backend, how = tp_backend()
    result: dict = {"phase": "serve_tp", "backend": backend, "ranks": how}
    need = {"dense": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode"),
            "paged": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode_paged")}
    with tempfile.TemporaryDirectory() as tmp:
        presets = {}
        for preset, quant in (("tiny", GGMLType.Q8_0),
                              ("tiny-k", GGMLType.Q4_K)):
            ws = make_synthetic_gguf(f"{tmp}/{preset}", preset, quant, seed=0,
                                     seq_len=256)
            cfg, model = load_gguf_model(ws / "model", device=dev)
            hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=256)
            hp.sampler.temperature = 0.0
            presets[preset] = (ws, InferenceEngine(model, cfg, hp,
                                                   device=dev))
        # the single-device servers' replies (the serve phase's, where it
        # ran: the same workspaces and traffic)
        want = {}
        for preset, (ws, _) in presets.items():
            hp = WorkspaceConfig.load(ws).hyper_params
            hp.max_slots = 4
            want[preset] = (SERVED.get(f"serve_{preset}")
                            or serve_run(ws, hp, "cuda")["tokens"])
        # one context (one rank group) a layout, serving both workspaces'
        # model dirs by their paths under tmp
        for label, tp, dp, pages, names in (
                ("tp2_dense", 2, 1, 0, ("model", "model+self:1")),
                ("tp2_paged", 2, 1, 10, ("model",)),
                ("tp2_dp2_paged", 2, 2, 20, ("model",))):
            t0 = time.perf_counter()
            hp = WorkspaceConfig.load(presets["tiny"][0]).hyper_params
            hp.max_slots, hp.paged_pages, hp.page_size = 4, pages, 8
            ctx = ServerContext(tmp, "tiny/model", hp, "cuda", tp=tp, dp=dp,
                                dist_backend=backend)
            try:
                for preset, (ws, engine) in presets.items():
                    for name in names:
                        run = serve_run(ws, hp, "cuda",
                                        f"{preset}/{name}", ctx=ctx,
                                        same_chats=dp == 1)
                        key = f"{label}_{preset}_{name}"
                        gaps = [agree(f"serve_tp {key}", ids,
                                      want[preset][p], engine, list(p))
                                for p, ids in run["all_tokens"]]
                        rk = (SPEC_NEED if "+" in name
                              else need["paged" if pages else "dense"])
                        result[key] = dict(
                            texts=run["texts"],
                            near_ties=[x for x in gaps if x is not None],
                            preemptions=run["metrics"].get(
                                "paged_preemptions_total"),
                            rank_launches=rank_counts(
                                run["rank_launches"], rk, f"serve_tp {key}"))
                        if pages == 10 and not run["metrics"][
                                "paged_preemptions_total"] > 0:
                            raise AssertionError(f"serve_tp {key}: no "
                                                 f"preemption")
            finally:
                ctx.close()
            result[f"{label}_s"] = time.perf_counter() - t0
    return result


# -- pipeline and sequence parallelism on one rank group ------------------

PP, SP = 2, 2
PP_SP_PRESET = "llama-8b"
# the tp x sp cache: 4,096 positions, 2,048 a sequence-parallel rank
SP_SEQ = 4096
# the tp x sp model's depth: llama-8b's first 8 layers (the time limit's
# cut; every sp phase runs it, against a single-device twin built at the
# same depth from the same seed)
SP_LAYERS = 8
# logits over tp = 2 x sp = 2 against one device, as a share of the
# range: TP_LOGIT_REL's reasons, and each rank rounds p * vs to bf16 at
# its own running maximum before the merge adds the ranks' states in
# another order
SP_LOGIT_REL = 2e-2
# two slots: a prefill tick's rows cross the host in every collective
PP_SP_HP = dict(max_slots=2, batch_size=128, max_seq_len=SP_SEQ)


@contextlib.contextmanager
def pp_sp_context(dev: torch.device):
    """One ServerContext over tp = 2 x sp = 2 ranks (gloo with the four on
    the one card, nccl with a card a rank where there are four) that the
    pp and sp phases share: the sp model is built on the context's mesh,
    the pp = 2 model on its first two ranks, and both are served from
    it, so the followers start once."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.serving.server import ServerContext

    world = TP * SP
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = ServerContext(tmp, "model", HyperParams(**PP_SP_HP), dev.type,
                            tp=TP, sp=SP, dist_backend=backend)
        ctx.start_s = time.perf_counter() - t0
        ctx.how = (f"{world} ranks over {backend}"
                   + (" on one card: a check of function, not of speed"
                      if backend == "gloo" else ", a card a rank"))
        try:
            yield ctx
        finally:
            ctx.close()


def stage_counts(counts: list[dict], need: dict, label: str) -> list[dict]:
    """Each rank's launches of the kernels need[rank] names (a pp stage
    runs its own part of the path); every rank must have launched each."""
    out = [{k: c[k] for k in need[r]} for r, c in enumerate(counts)
           if r in need]
    for r, c in zip(need, out):
        missing = [k for k, n in c.items() if not n]
        if missing:
            raise AssertionError(f"{label}: rank {r} launched no {missing}")
    return out


def phase_pp_full_width(dev: torch.device, cfg, model, ctx) -> tuple:
    """llama-8b Q4_K over two pipeline stages (parallel/pp.py; ranks 0
    and 1 of the context's group, 16 layers a stage, random weights from
    seed 0 on each): a 512-token prefill and greedy decoding to 32
    tokens, logits and tokens bit for bit the single-device forward's
    on the same card, the cache put together over the stages bit for
    bit; the wall time of each path beside one device's (eager), the ms
    of one stage-to-stage hop of the residual, and the GPipe prefill of
    8 slots x 128 tokens in 4 microbatches beside one. Each rank's
    launches zeroed before each path and read after it."""
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.parallel.pp import (pp_decode_scan, pp_forward,
                                                  pp_handoff_ms,
                                                  pp_prefill_microbatched)

    group, llm = ctx.ranks, cfg.llm
    n_prompt, n_tokens, max_seq = 512, 32, 2048
    out: dict = {"phase": "pp_full_width", "pp": PP, "ranks": ctx.how,
                 "start_s": ctx.start_s}
    t0 = time.perf_counter()
    _, pm = group.preset(PP_SP_PRESET, "q4_k", 0, 1, pp=PP)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    stage = pm.shard.model
    if len(stage.layers) != llm.n_layers // PP:
        raise AssertionError(f"pp stage 0 holds {len(stage.layers)} layers")
    out["stage_layers"] = len(stage.layers)
    g = torch.Generator(device="cpu")
    g.manual_seed(1)
    prompt = torch.randint(3, llm.vocab_size, (1, n_prompt),
                           generator=g).to(dev)
    pos = torch.arange(n_prompt, device=dev)[None]
    args = (llm.n_layers, 1, max_seq, llm.n_kv_heads, llm.head_size)
    kv1, kv2 = KVCache.create(*args, dev), pm.create_cache(*args)
    counts = {}

    def timed(name, fn, need=None):
        group.launch_counts(reset=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_wall_s"] = time.perf_counter() - t
        if need is not None:
            counts[name] = stage_counts(group.launch_counts(), need,
                                        f"pp {name}")
        return res

    stages = {0: ("qmatmul", "flash_prefill"),
              1: ("qmatmul", "flash_prefill", "fused_head")}
    want = timed("one_device_prefill", lambda: model(
        kv1, prompt, pos, logits_mode="last"))
    got = timed("prefill", lambda: pp_forward(pm, kv2, prompt, pos,
                                              logits_mode="last"), stages)
    if not torch.equal(got, want):
        raise AssertionError(f"pp prefill: logits differ from one "
                             f"device's by {logit_gap(got, want)}")
    first = want.argmax(-1).to(torch.int32)

    def one_device():
        toks, tok = [], first
        for _ in range(n_tokens - 1):
            tok = model(kv1, tok[:, None], kv1.pos.long()[:, None],
                        logits_mode="argmax")
            toks.append(tok)
        return torch.stack(toks, 1)

    ref = timed("one_device_decode", one_device)
    stages = {0: ("qmatmul", "flash_decode"),
              1: ("qmatmul", "flash_decode", "fused_head")}
    toks = timed("decode", lambda: pp_decode_scan(pm, first, kv2,
                                                  n_tokens - 1), stages)
    if not torch.equal(toks, ref):
        raise AssertionError(f"pp decode: tokens {toks.tolist()} vs one "
                             f"device's {ref.tolist()}")
    whole = kv2.gathered()
    for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
        if not torch.equal(whole[name], getattr(kv1, name)):
            raise AssertionError(f"pp cache: {name} differs from one "
                                 f"device's")
    del whole
    out.update(
        tokens_equal=True, logits_bit_equal=True, cache_bit_equal=True,
        prefill_tok_s=n_prompt / out["prefill_wall_s"],
        one_device_prefill_tok_s=n_prompt / out["one_device_prefill_wall_s"],
        decode_tok_s=(n_tokens - 1) / out["decode_wall_s"],
        one_device_decode_tok_s=(n_tokens - 1)
        / out["one_device_decode_wall_s"],
        hop_ms={f"{s}x{t}x4096": pp_handoff_ms(pm, (s, t, 4096), 20)
                for s, t in ((1, 1), (8, 1), (1, 512))})
    del kv1, kv2
    # GPipe: 8 slots x 128 tokens, one microbatch against four
    S, C = 8, 128
    toks8 = torch.randint(3, llm.vocab_size, (S, C), generator=g).to(dev)
    pos8 = torch.arange(C, device=dev)[None].expand(S, C)
    micro = {}
    for n_micro in (1, 4, 1, 4):
        kv = pm.create_cache(llm.n_layers, S, max_seq, llm.n_kv_heads,
                             llm.head_size)
        timed("micro", lambda: pp_prefill_microbatched(pm, kv, toks8, pos8,
                                                       n_micro))
        if kv.pos.tolist() != [C] * S:
            raise AssertionError(f"pp microbatched prefill: pos "
                                 f"{kv.pos.tolist()}")
        micro.setdefault(n_micro, []).append(S * C / out.pop("micro_wall_s"))
        del kv
    out["microbatched_prefill_tok_s"] = {f"n_micro_{k}": v
                                         for k, v in micro.items()}
    out["launches"] = counts
    return out, pm


def phase_sp_full_width(dev: torch.device, ctx) -> tuple:
    """llama-8b Q4_K cut to SP_LAYERS layers over tp = 2 x sp = 2 (the
    context's four ranks, random weights from seed 0 on each, 16/4 heads
    a rank; its single-device twin built at that depth on the card) with
    a 4,096-position cache, 2,048 a rank: a 2,100-token prompt in three
    700-token chunks (the third straddles the slices' boundary) and 16
    greedy tokens on the second slice; each chunk's logits against the
    single-device forward on the same card (SP_LOGIT_REL, the greedy
    token one device's unless its top-2 gap is < NEAR_TIE), the tokens
    by the near-tie rule, the cache put together over tp and sp: mask
    and pos one device's, layer 0's K/V bit for bit (the later layers'
    share of equal entries reported: the merge's roundings feed their
    quantization). Wall times beside one device's, each rank's
    launches. Returns (line, the sp model, rank 0's launches, the twin's
    (cfg, model))."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.parallel.tp import tp_decode_scan
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    cfg, model = make_device_params(PP_SP_PRESET, "q4_k", seed=0,
                                    device=dev, layers=SP_LAYERS)
    group, llm = ctx.ranks, cfg.llm
    # 2,100 tokens in chunks of 700 at 4,096 positions: the last chunk
    # straddles the slices
    chunk, n_tokens = (SP_SEQ // 2 + SP_SEQ // 78) // 3, 16
    n_prompt = 3 * chunk
    out: dict = {"phase": "sp_full_width", "tp": TP, "sp": SP,
                 "ranks": ctx.how, "max_seq": SP_SEQ,
                 "cuts": {PP_SP_PRESET: f"32 -> {SP_LAYERS} layers"}}
    t0 = time.perf_counter()
    _, sm = group.preset(PP_SP_PRESET, "q4_k", 0, TP, sp=SP,
                         layers=SP_LAYERS)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    args = (llm.n_layers, 1, SP_SEQ, llm.n_kv_heads, llm.head_size)
    kv1, kv2 = KVCache.create(*args, dev), sm.create_cache(*args)
    local = (sm.shard.model.llm.n_heads, sm.shard.model.llm.n_kv_heads,
             kv2.shard.kv.t_local)
    if local != (llm.n_heads // TP, llm.n_kv_heads // TP, SP_SEQ // SP):
        raise AssertionError(f"tp x sp shards (heads, kv heads, positions "
                             f"a rank): {local}")
    out["local_shapes"] = local
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    counts, gaps = {}, []

    def timed(name, fn, need=None):
        group.launch_counts(reset=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_wall_s"] = out.get(f"{name}_wall_s", 0.0) + (
            time.perf_counter() - t)
        if need is not None:
            counts[name] = rank_counts(group.launch_counts(), need,
                                       f"sp {name}")
        return res

    for c0 in range(0, n_prompt, chunk):
        toks = prompt[None, c0:c0 + chunk].to(dev)
        pos = torch.arange(c0, c0 + chunk, device=dev)[None]
        want = timed("one_device_prefill", lambda: model(
            kv1, toks, pos, logits_mode="last"))
        got = timed("prefill", lambda: sm(kv2, toks, pos,
                                          logits_mode="last"),
                    ("qmatmul", "flash_prefill_state", "fused_head"))
        gap = logit_gap(got, want)
        top2 = want[0].topk(2).values
        if not gap <= SP_LOGIT_REL or (
                got.argmax() != want.argmax()
                and float(top2[0] - top2[1]) >= NEAR_TIE):
            raise AssertionError(f"sp prefill chunk at {c0}: {gap} of the "
                                 f"range")
        gaps.append(gap)
    out["prefill_logit_gaps"] = gaps
    first = want.argmax(-1).to(torch.int32)

    def one_device():
        toks, tok = [], first
        for _ in range(n_tokens - 1):
            tok = model(kv1, tok[:, None], kv1.pos.long()[:, None],
                        logits_mode="argmax")
            toks.append(tok)
        return torch.stack(toks, 1)

    ref = timed("one_device_decode", one_device)
    got_t = timed("decode", lambda: tp_decode_scan(sm, first, kv2,
                                                   n_tokens - 1),
                  ("qmatmul", "flash_decode_state", "fused_head"))
    hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=SP_SEQ)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    plist = prompt.tolist() + [int(first)]
    out["near_tie_gap"] = agree("sp greedy vs one device",
                                got_t[0].tolist(), ref[0].tolist(), engine,
                                plist)
    out["tokens_equal"] = got_t.tolist() == ref.tolist()
    del engine
    whole = kv2.gathered()
    for name in ("mask", "pos"):
        if not torch.equal(whole[name], getattr(kv1, name)):
            raise AssertionError(f"sp cache: {name} differs from one "
                                 f"device's")
    same = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = whole[name], getattr(kv1, name)
        if not torch.equal(a[0], b[0]):
            raise AssertionError(f"sp cache: layer 0's {name} differs from "
                                 f"one device's")
        same[name] = (a == b).float().mean().item()
    del whole
    out.update(
        layer0_bit_equal=True, equal_share=same,
        prefill_tok_s=n_prompt / out["prefill_wall_s"],
        one_device_prefill_tok_s=n_prompt / out["one_device_prefill_wall_s"],
        decode_tok_s=(n_tokens - 1) / out["decode_wall_s"],
        one_device_decode_tok_s=(n_tokens - 1)
        / out["one_device_decode_wall_s"], launches=counts)
    return (out, sm, counts["decode"][0] | counts["prefill"][0],
            (cfg, model))


def phase_serve_pp_sp(dev: torch.device, cfg, model, ctx, pm, sm,
                      sp_twin) -> dict:
    """The HTTP server over the context's rank group with both models
    registered: "pp" (two stages) and "sp" (tp = 2 x sp = 2, SP_LAYERS
    layers; sp_twin its single-device (cfg, model)), 2 slots,
    4,096 positions; concurrent greedy completions, to "pp" 4 of 204 to
    2,457 prompt tokens and 16 new ones, to "sp" the shortest and the
    longest of them (which crosses the slices' boundary) and 8 new ones
    (its gloo collectives cost ~4 ms each on one card): all finish
    "length", every reply a lone one-device generate's (near-tie rule),
    no request in error, each rank's launches of its path's kernels;
    generated tok/s of each."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine

    import random

    tok = synthetic_tokenizer(cfg.llm.vocab_size)
    hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=SP_SEQ)
    hp.sampler.temperature = 0.0
    engines = {"pp": InferenceEngine(model, cfg, hp, device=dev),
               "sp": InferenceEngine(sp_twin[1], sp_twin[0], hp,
                                     device=dev)}
    rng = random.Random(3)
    lengths = [SP_SEQ * k // 80 for k in (4, 16, 28, 48)]
    texts = ["".join(rng.choice("abcdefghijklmnopqrsuvwxyz")
                     for _ in range(n - 4)) for n in lengths]
    traffic = {"pp": (texts, 16), "sp": ([texts[0], texts[-1]], 8)}
    out: dict = {"phase": "serve_pp_sp", "ranks": ctx.how,
                 "prompt_tokens": lengths,  # 204 to 2,457 at 4,096
                 "cuts": {"sp": f"{PP_SP_PRESET} 32 -> {SP_LAYERS} layers"}}
    ctx.register("pp", pm, cfg, tok)
    ctx.register("sp", sm, sp_twin[0], tok)
    need = {"pp": {0: ("qmatmul", "flash_prefill", "flash_decode"),
                   1: ("qmatmul", "flash_prefill", "flash_decode",
                       "fused_head")},
            "sp": {r: ("qmatmul", "fused_head", "flash_prefill_state",
                       "flash_decode_state") for r in range(TP * SP)}}
    server = serving(ctx)
    port = server.server_address[1]
    try:
        for name, (prompts, n_new) in traffic.items():
            calls = [lambda t=t: http_call(port, "POST", "/v1/completions", {
                "model": name, "prompt": t, "max_tokens": n_new,
                "temperature": 0}) for t in prompts]
            with ServeRecorder() as rec:
                ctx.ranks.launch_counts(reset=True)
                t0 = time.perf_counter()
                replies = concurrently(calls)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ctx.ranks.launch_counts()
            rec.check(f"serve_pp_sp {name}")
            for status, data in replies:
                if status != 200 or json.loads(data)["choices"][0][
                        "finish_reason"] != "length":
                    raise AssertionError(f"serve_pp_sp {name}: {status} "
                                         f"{data[:200]}")
            gaps, engine = [], engines[name]
            for p, ids in rec.tokens().items():
                want = list(engine.generate(list(p), n_new))
                gaps.append(agree(f"serve_pp_sp {name}", ids, want, engine,
                                  list(p)))
            out[name] = dict(
                generated_tok_s=n_new * len(prompts) / wall, wall_s=wall,
                near_ties=[x for x in gaps if x is not None],
                rank_launches=stage_counts(launches, need[name],
                                           f"serve_pp_sp {name}"))
    finally:
        server.shutdown()
        server.server_close()
    return out


# -- what sp serves since the compositions were ported: MoE models,
#    InternVL, token trees and EAGLE heads over tp = 2 x sp = 2 ---------

# their cache: 512 positions, 256 a sequence-parallel rank (the slices'
# boundary sits inside each prompt's tree or decoding)
SPC_SEQ = 512
SPC_NEW = 8


def phase_sp_compositions_full_width(dev: torch.device, sp_twin, ctx, sm,
                                     head_dir: str) -> tuple:
    """The scheduler (BatchScheduler, the server's) over the context's
    tp = 2 x sp = 2 ranks at full widths, each composition a greedy
    request of SPC_NEW tokens whose tree or decoding crosses position
    256, the slices' boundary: llama-8b Q4_K (sm, SP_LAYERS layers;
    sp_twin its single-device (cfg, model)) with the
    4-layer self-draft's [2, 1, 1] tree (a 253-token prompt: the first
    tree's nodes at 253..259) and with the random EAGLE head's chain (k =
    4) and [2, 1, 1] tree (the head's cache whole on every sp rank);
    mixtral-lite Q4_K cut to COMPOSE_LAYERS layers (the grouped expert
    route); InternVL2.5-4B (the text cut to COMPOSE_LAYERS layers, the
    tower on rank 0's card) with one 448 x 448 PNG whose 256 image rows
    sit at 10..265. Each reply against the single device's greedy
    tokens on the same card (generate, or VLMEngine.generate; near-tie
    rule: speculation returns the target's tokens), each rank's
    launches of every kernel of the path, the wall time of each."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
    from powerserve_tpu_torch.engine.vlm import VLMEngine
    from powerserve_tpu_torch.tools.bench_params import (make_device_internvl,
                                                         make_device_params)
    from powerserve_tpu_torch.tools.synthetic import VLM_PRESETS

    group, L = ctx.ranks, COMPOSE_LAYERS
    cfg, model = sp_twin
    text_preset = VLM_PRESETS[VLM_PRESET][0]
    out: dict = {"phase": "sp_compositions_full_width", "tp": TP, "sp": SP,
                 "ranks": ctx.how, "max_seq": SPC_SEQ, "card": card_line(),
                 "cuts": {PP_SP_PRESET: f"32 -> {SP_LAYERS} layers",
                          "mixtral-lite": f"32 -> {L} layers",
                          f"{text_preset} (InternVL2.5-4B's text)":
                              f"36 -> {L} layers",
                          "cache": f"{SPC_SEQ} positions, "
                                   f"{SPC_SEQ // SP} a rank"}}

    def hp(**kw) -> HyperParams:
        return HyperParams(max_slots=1, batch_size=128, max_seq_len=SPC_SEQ,
                           prefix_cache=0, **kw)

    def reference(m, c) -> InferenceEngine:
        h = HyperParams(max_slots=1, batch_size=128, max_seq_len=SPC_SEQ)
        h.sampler.temperature = 0.0
        return InferenceEngine(m, c, h, device=dev)

    def run(label, sched, prompt, need, embeds=None) -> tuple:
        """One greedy request through sched.step(), each rank's launches
        zeroed just before and read just after."""
        toks, done = [], []
        sched.submit(Request(prompt_ids=list(prompt), max_tokens=SPC_NEW,
                             temperature=0.0, embeds=embeds,
                             sink=lambda t: done.append(True) if t is None
                             else toks.append(t)))
        group.launch_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            if done:
                break
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not done or len(toks) != SPC_NEW:
            raise AssertionError(f"sp {label}: {len(toks)} tokens, "
                                 f"finished {bool(done)}")
        counts = rank_counts(group.launch_counts(), need, f"sp {label}")
        res = dict(wall_s=wall, tokens=toks, rank_launches=counts)
        if sched.draft is not None:
            m = sched.metrics()
            res.update(spec_steps=sched.n_spec_steps,
                       accepted=sched.n_spec_accepted,
                       drafted=sched.n_spec_drafted,
                       tokens_per_step=m.get("spec_tokens_per_step"))
        sched.release()
        return res, counts

    g = torch.Generator(device="cpu")
    g.manual_seed(21)
    half = SPC_SEQ // SP
    llm = cfg.llm
    prompt = torch.randint(3, llm.vocab_size, (half - 3,),
                           generator=g).tolist()
    engine = reference(model, cfg)
    want = list(engine.generate(prompt, SPC_NEW))
    heads = {}
    tree_counts = None
    for label, kw, extra, need in (
            ("tree_self_draft_4", dict(spec_tree="2,1,1"), "self:4",
             ("qmatmul", "fused_head", "flash_prefill_state",
              "flash_decode_state_tree")),
            ("eagle_chain", dict(spec_k=4), "eagle",
             ("fused_concat2", "qmatmul", "fused_head", "flash_prefill",
              "flash_prefill_state", "flash_decode", "flash_decode_state")),
            ("eagle_tree", dict(spec_tree="2,1,1"), "eagle",
             ("fused_concat2", "qmatmul", "fused_head", "flash_prefill",
              "flash_prefill_state", "flash_decode_tree",
              "flash_decode_state_tree"))):
        if extra == "eagle":
            if "eagle" not in heads:
                heads["eagle"] = group.eagle(sm, head_dir)
            spec = dict(eagle_head=heads["eagle"])
        else:
            spec = dict(draft=group.self_draft(sm, 4))
        res, counts = run(label, BatchScheduler(sm, cfg, hp(**kw), dev,
                                                **spec), prompt, need)
        res["near_tie_gap"] = agree(f"sp {label} vs one device",
                                    res["tokens"], want, engine, prompt)
        res["tokens_equal"] = res["tokens"] == want
        out[label] = res
        if label == "tree_self_draft_4":
            tree_counts = counts[0]
    del heads, engine
    # mixtral-lite: the grouped expert route over the slices
    t0 = time.perf_counter()
    mcfg, one = make_device_params("mixtral-lite", "q4_k", seed=0,
                                   device=dev, layers=L)
    _, tm = group.preset("mixtral-lite", "q4_k", 0, TP, layers=L, sp=SP)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mprompt = torch.randint(3, mcfg.llm.vocab_size, (half - 3,),
                            generator=g).tolist()
    engine = reference(one, mcfg)
    mwant = list(engine.generate(mprompt, SPC_NEW))
    res, _ = run("moe", BatchScheduler(tm, mcfg, hp(), dev), mprompt,
                 ("qmatmul", "qmatmul_grouped", "fused_head",
                  "flash_prefill_state", "flash_decode_state"))
    res.update(preset="mixtral-lite", layers=L, build_s=build_s,
               near_tie_gap=agree("sp moe vs one device", res["tokens"],
                                  mwant, engine, mprompt),
               tokens_equal=res["tokens"] == mwant)
    out["moe"] = res
    del one, tm, engine
    torch.cuda.empty_cache()
    # InternVL2.5-4B: one image's rows across the boundary
    t0 = time.perf_counter()
    vlm = make_device_internvl(VLM_PRESET, "q4_k", seed=0, device=dev,
                               text_layers=L)
    vcfg, tm = group.preset(text_preset, "q4_k", 0, TP, layers=L, sp=SP)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, img = vlm_png(21, 448, 448)
    vengine = VLMEngine(vlm, HyperParams(max_seq_len=SPC_SEQ,
                                         batch_size=128), device=dev)
    px = torch.as_tensor(vengine.pixel_values([img]), device=dev)
    vprompt = (torch.randint(3, 1000, (10,), generator=g).tolist()
               + [vlm.image_token_id]
               + torch.randint(3, 1000, (6,), generator=g).tolist())
    ids = vlm.expand_image_tokens(vprompt, px.shape[0])
    image = [i for i, t in enumerate(ids) if t == vlm.image_token_id]
    if not image[0] < half <= image[-1]:
        raise AssertionError(f"sp vlm: image rows {image[0]}..{image[-1]} "
                             f"do not cross {half}")
    rows = vlm.embed_multimodal(torch.tensor([ids], device=dev), px)[0]
    vwant = list(vengine.generate(vprompt, [img], SPC_NEW))
    res, _ = run("vlm", BatchScheduler(tm, vcfg, hp(), dev), ids,
                 ("qmatmul", "fused_head", "flash_prefill_state",
                  "flash_decode_state"), embeds=rows.to(torch.bfloat16))
    res.update(preset=VLM_PRESET, text_layers=L, build_s=build_s,
               image_rows=[image[0], image[-1]],
               near_tie_gap=mm_agree("sp vlm vs VLMEngine", res["tokens"],
                                     vwant, vlm, ids, px),
               tokens_equal=res["tokens"] == vwant)
    out["vlm"] = res
    del vlm, tm, vengine
    torch.cuda.empty_cache()
    return out, tree_counts


# -- PR 16's phases: W8 from `run`, W8 expert slabs, tracing, the native
#    host runtime ----------------------------------------------------------


def phase_weight_format() -> dict:
    """`run --weight-format w8` on tiny-k Q4_K (every projection has K =
    256: all of them W8) on cuda and on the cpu plain path: greedy tokens
    agree (near-tie rule, the cpu engine's logits); the cuda run launched
    the W8 kernel and never the fused head."""
    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.config import WorkspaceConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    with tempfile.TemporaryDirectory() as tmp:
        ws = make_synthetic_gguf(f"{tmp}/tiny-k", "tiny-k", GGMLType.Q4_K,
                                 seed=0, seq_len=256)
        argv = ["-d", str(ws), "-p", "The quick brown fox", "-n", "16",
                "--temperature", "0", "--no-progress", "--weight-format",
                "w8"]
        cuda_lib.reset_launch_counts()
        gpu = run.run_prompt(run.parse_args(argv + ["--device", "cuda"]))
        counts = cuda_lib.launch_counts()
        missing = [k for k in ("qmatmul_w8", "flash_prefill", "flash_decode")
                   if not counts[k]]
        if missing or counts["fused_head"] or counts["qmatmul"]:
            raise AssertionError(f"run --weight-format w8 on cuda: missing "
                                 f"{missing} or a GGUF-format launch: "
                                 f"{counts}")
        cpu = run.run_prompt(run.parse_args(argv + ["--device", "cpu"]))
        eng_cpu, _ = run.build_engine(
            str(ws / "model"), WorkspaceConfig.load(ws).hyper_params, "cpu",
            mxu=True)
        gap = agree("run --weight-format w8", gpu.ids, cpu.ids, eng_cpu,
                    gpu.prompt_ids)
    return {"phase": "weight_format", "preset": "tiny-k", "format": "w8",
            "tokens_cuda": gpu.ids, "tokens_cpu": cpu.ids,
            "first_divergence": first_divergence(gpu.ids, cpu.ids),
            "top2_gap": gap, "launches": counts}


def w8_grouped_calls_check(fn) -> tuple[float, int]:
    """Run fn with every grouped product of the forward computed by the
    kernel and, on the same rows and tile ids, by its twin; each W8 one
    within 1e-4 of its largest output. Returns (max error share, W8
    calls)."""
    from unittest import mock

    import powerserve_tpu_torch.models.llama as llama
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_grouped,
                                                  qmatmul_grouped_reference)

    errs = []

    def both(x, lin, ids, bm):
        y = qmatmul_grouped(x, lin, ids, bm)
        if lin.w8:
            ref = qmatmul_grouped_reference(x, lin, ids, bm)
            errs.append((y - ref).abs().max().item()
                        / max(1.0, ref.abs().max().item()))
        return y

    with mock.patch.object(llama, "qmatmul_grouped", both):
        fn()
    if not errs or max(errs) > 1e-4:
        raise AssertionError(f"W8 grouped products against their twin: "
                             f"{len(errs)} calls, max error share "
                             f"{max(errs or [0])}")
    return max(errs), len(errs)


def phase_w8_moe_full_width(dev: torch.device) -> tuple[dict, dict, list]:
    """mixtral-lite in the W8 format (make_device_params(quant="w8"):
    every projection W8, the expert slabs int8 [8, K, N] with per-128
    scales): the grouped mode of csrc/qmatmul_w8.cu on layer 0's slabs,
    routed by its router, at the gate (4096 -> 3584) and down (3584 ->
    4096) shapes of a 512-token prefill (block_m 128, P = 2048, 1,024
    routed rows), 32 and 8 decoding slots (block_m 16, 64 and 16 routed
    rows) and one token (its top-2 slabs as one-row tiles), each against
    its twin within 1e-4 of the largest output, twice bit for bit, timed
    beside the Q4_K grouped mode at the same shapes and routing; generate (512 + 64
    greedy tokens, replayed, a first and a steady call); an S = 8 decode
    step whose every grouped and dense W8 product is held against its twin
    (random full-range int8 weights are not held end to end: PERF.md),
    then timed eager and replayed as a CUDA graph (CUDA events), with its
    launches;
    each MoE route under set_sync_debug_mode("error"). Returns (result,
    the steady generate's launches, the kernel rows)."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)
    from powerserve_tpu_torch.engine.graphs import StepGraph
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.llama import moe_route
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.moe import group_dispatch
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_grouped_cuda,
                                                  qmatmul_grouped_reference,
                                                  qmatmul_w8_grouped_cuda)
    from powerserve_tpu_torch.tools.bench_params import (_rand_qlinear,
                                                         make_device_params)

    counted = Counted()
    t0 = time.perf_counter()
    cfg, model = make_device_params("mixtral-lite", "w8", seed=0, device=dev)
    torch.cuda.synchronize()
    llm = cfg.llm
    E, k, dim, ffn = llm.n_experts, llm.n_experts_used, llm.dim, llm.hidden_dim
    layer = model.layers[0]
    if not (layer.w_gate_exps.w8 and layer.wqkv.w8 and model.lm_head.w8):
        raise AssertionError("mixtral-lite w8: a weight is not W8")
    result: dict = {"phase": "w8_moe_full_width", "card": card_line(),
                    "preset": "mixtral-lite", "quant": "w8",
                    "build_s": time.perf_counter() - t0,
                    "layers": llm.n_layers, "experts": E, "top_k": k,
                    "expert_int8_gb": sum(
                        getattr(lw, n).q.numel() for lw in model.layers
                        for n in ("w_gate_exps", "w_up_exps", "w_down_exps"))
                    / 1e9}

    # -- the grouped mode against its twin, beside Q4_K's
    timer = Timer(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    q4 = {"gate": _rand_qlinear(g, dim, ffn, "q4_k", dev, E),
          "down": _rand_qlinear(g, ffn, dim, "q4_k", dev, E)}
    w8 = {"gate": layer.w_gate_exps, "down": layer.w_down_exps}
    rows = []
    for case, n_tok, bm in (("prefill 512 tokens", 512, 128),
                            ("decode 32 slots", 32, 16),
                            ("decode 8 slots", 8, 16),
                            ("single token", 1, 1)):
        h = torch.randn(n_tok, dim, generator=g, device=dev).to(
            torch.bfloat16)
        topi, topw = layer.route(h, k)
        if bm == 1:
            ids = topi[0].to(torch.int32)
            rows_of = lambda t: t.expand(k, -1).contiguous()  # noqa: E731
        else:
            tok, _, ids = group_dispatch(topi, topw, E, 0, bm)
            rows_of = lambda t: t[tok.clamp(min=0).long()]  # noqa: E731
        distinct = int(ids.unique().numel())
        routed = n_tok * k
        for proj, K, N in (("gate", dim, ffn), ("down", ffn, dim)):
            x = rows_of(h if proj == "gate" else torch.randn(
                n_tok, K, generator=g, device=dev).to(torch.bfloat16))
            for quant, stack, fn, peak in (
                    ("w8", w8[proj], qmatmul_w8_grouped_cuda, INT8_OP_PER_S),
                    ("q4_k", q4[proj], qmatmul_grouped_cuda,
                     BF16_FLOP_PER_S)):
                label = f"{quant} grouped {case} {proj}"
                ref = qmatmul_grouped_reference(x, stack, ids, bm)
                got = fn(x, stack, ids, bm)
                err = (got - ref).abs().max().item()
                if err > 1e-4 * max(1.0, ref.abs().max().item()):
                    raise AssertionError(f"{label}: max abs err {err}")
                if not torch.equal(got, fn(x, stack, ids, bm)):
                    raise AssertionError(f"{label}: two runs gave different "
                                         f"bits")
                b, by = bound_ms(routed * K * x.element_size() + nbytes(ids)
                                 + distinct * stack.nbytes() // E
                                 + routed * N * 4, 2.0 * routed * N * K,
                                 peak=peak)
                rows.append(dict(
                    case=case, proj=proj, quant=quant, k=K, n=N,
                    block_m=bm, P=x.shape[0], routed_rows=routed,
                    distinct_slabs=distinct, max_abs_err=err,
                    ms=timer(lambda: fn(x, stack, ids, bm)),
                    plain_ms=timer(lambda: qmatmul_grouped_reference(
                        x, stack, ids, bm), reps=3),
                    bound_ms=b, bound_by=by, library_ms=None))
    del q4, timer
    result["grouped_rows"] = rows

    # -- generate: the grouped prefill (block_m 128), then the single-token
    #    route, replayed; a first call and a steady one
    gcpu = torch.Generator(device="cpu")
    gcpu.manual_seed(2)
    n_prompt, n_new = 512, 64
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=gcpu)
    hp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    need = ("qmatmul_w8", "qmatmul_w8_grouped", "flash_prefill",
            "flash_decode")
    runs = []
    for path in ("generate", "generate again"):
        engine.reset()
        stats = GenerationStats()
        ids, gen_s = counted(path, need, lambda: list(engine.generate(
            prompt.tolist(), n_new, stats=stats)),
            absent=("fused_head", "qmatmul", "qmatmul_grouped"))
        if len(ids) != n_new or not all(0 <= t < llm.vocab_size
                                        for t in ids):
            raise AssertionError(f"mixtral-lite w8 {path} gave {ids}")
        runs.append((ids, stats))
    if runs[0][0] != runs[1][0]:
        raise AssertionError("mixtral-lite w8: the steady generate's tokens "
                             "differ from the first's")
    graphs = graph_stats(engine.graphs)
    del engine
    result.update(routes_generate=[moe_route(n_prompt), moe_route(1)],
                  prefill_tok_s=runs[1][1].prefill_speed,
                  first_prefill_tok_s=runs[0][1].prefill_speed,
                  generate_decode_tok_s=runs[0][1].decode_speed,
                  generate_again_decode_tok_s=runs[1][1].decode_speed,
                  generate_graphs=graphs, tokens=runs[0][0][:16])

    # -- an S = 8 decode step (block_m 16): every W8 product, grouped and
    #    dense, against its twin on its own input
    kv = KVCache.create(llm.n_layers, 8, 256, llm.n_kv_heads, llm.head_size,
                        dev)
    toks = torch.randint(3, llm.vocab_size, (8, 65), generator=gcpu).to(dev)
    pos = torch.arange(64, device=dev).expand(8, 64).contiguous()
    model(kv, toks[:, :64], pos, logits_mode="none")
    step = lambda: model(kv.clone(), toks[:, 64:],  # noqa: E731
                         kv.pos.long()[:, None], logits_mode="last")
    dense = {}
    g_err, g_calls = w8_grouped_calls_check(
        lambda: dense.update(calls=w8_calls_check(step)))
    d_err, d_calls = dense["calls"]
    # the same step on the kernels, timed with CUDA events (median of 11,
    # warm; a clone of the cache, its position 64 written again each
    # call): eager, where the host's launches set the pace, then replayed
    # as one CUDA graph (engine/graphs.py's StepGraph), the device's time;
    # and its launches (zeroed just before one eager step, read after)
    kv_t = kv.clone()
    pos = kv.pos.long()[:, None]
    run_step = lambda: model(kv_t, toks[:, 64:], pos,  # noqa: E731
                             logits_mode="last")

    def median_ms(fn, reps=11):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    run_step()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    run_step()
    torch.cuda.synchronize()
    step_counts = {n: c for n, c in cuda_lib.launch_counts().items() if c}
    eager_ms, eager_runs = median_ms(run_step)
    graph = StepGraph(run_step, {}, dev, None, torch.cuda.Stream(dev), ())
    graph()  # eager, then captured and replayed
    graph()
    replay_ms, replay_runs = median_ms(graph)
    result["decode_step"] = dict(route=moe_route(8), grouped_calls=g_calls,
                                 grouped_err_share=g_err,
                                 dense_calls=d_calls, dense_err_share=d_err,
                                 eager_ms=eager_ms, eager_ms_runs=eager_runs,
                                 replayed_ms=replay_ms,
                                 replayed_ms_runs=replay_runs,
                                 launches=step_counts)
    del kv_t, graph, kv
    # -- every route without a host sync
    routes = []
    for n in (1, 8, 512):
        h = torch.randn(n, dim, generator=gcpu).to(dev, torch.bfloat16)
        routes.append(moe_ffn_without_sync(f"mixtral-lite w8 {n} rows",
                                           layer, h, k))
    if set(map(tuple, routes)) != {("single", 1), ("grouped", 16),
                                   ("grouped", 128)}:
        raise AssertionError(f"mixtral-lite w8: routes driven {routes}")
    result.update(sync_free_routes=routes, launches=counted.launches)
    del model, layer
    torch.cuda.empty_cache()
    return result, counted.launches["generate again"], rows


def paged_tick_copies(dev: torch.device, cfg, model, ticks: int = 8) -> dict:
    """Device-to-host copies per plain decode tick of the scheduler over a
    paged pool (8 slots, pages of 64): 8 requests admitted and prefilled,
    the tick's step graph captured, then `ticks` decode ticks under
    torch.profiler, counting its "Memcpy DtoH" device events. Uses only
    the scheduler's public surface, so a parent tree runs it too."""
    from torch.profiler import ProfilerActivity, profile

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request

    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=128, page_size=64, prefix_cache=0)
    sched = BatchScheduler(model, cfg, hp, dev)
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    done = []
    for _ in range(8):
        sched.submit(Request(
            prompt_ids=torch.randint(3, cfg.llm.vocab_size, (100,),
                                     generator=g).tolist(),
            max_tokens=256, temperature=0.0,
            sink=lambda t: t is None and done.append(1)))
    warm = 0
    while any(s.req is None or s.prefilling for s in sched.slots) or warm < 3:
        if not any(s.req is None or s.prefilling for s in sched.slots):
            warm += 1  # decode ticks: the first eager, then the capture
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            sched.step()
        torch.cuda.synchronize()
    if done or any(s.req is None or s.prefilling for s in sched.slots):
        raise AssertionError("paged tick copies: a slot left decoding")
    copies = [e for e in prof.events()
              if e.name.startswith("Memcpy DtoH")]
    sched.release()
    return {"ticks": ticks, "slots": 8, "decode_horizon": sched.horizon,
            "dtoh_copies": len(copies),
            "dtoh_copies_per_tick": len(copies) / ticks,
            "copy_names": sorted({e.name for e in copies})}


OWN_KERNELS = ("qmm_gemv_kernel", "qmm_mma_kernel", "flash_decode_kernel",
               "flash_prefill_kernel", "prologue_kernel",
               "argmax_reduce_kernel", "w8_")


def phase_trace(dev: torch.device, cfg, model) -> dict:
    """First the paged plain tick's device-to-host copies
    (paged_tick_copies), which must be one a tick: the process's first
    profiler session, since a session over replayed graphs (the trace
    below) leaves later sessions of the process without some device
    events. Then core/trace.py on llama-8b Q4_K: generate (a 256-token
    prompt in 128-token chunks, 16 greedy tokens in blocks of 4,
    replayed) untraced and under Trace: the same tokens; the trace's
    prefill and decode_step spans one a chunk and one a block; the
    port's kernels among its kernel events; decode tok/s with and
    without the trace."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.core.trace import Trace
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)

    ticks = paged_tick_copies(dev, cfg, model)
    if ticks["dtoh_copies_per_tick"] != 1:
        raise AssertionError(f"paged plain tick: {ticks}")
    llm = cfg.llm
    g = torch.Generator(device="cpu")
    g.manual_seed(6)
    prompt = torch.randint(3, llm.vocab_size, (257,), generator=g).tolist()
    hp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=128)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    list(engine.generate(prompt, 16))  # the step graph captured
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("untraced", "traced", "untraced again"):
            engine.reset()
            stats = GenerationStats()
            if label == "traced":
                Trace.start_tracing(tmp)
            ids = list(engine.generate(prompt, 16, stats=stats))
            path = Trace.stop_tracing() if label == "traced" else None
            out[label] = (ids, stats.decode_speed, path)
        path = out["traced"][2]
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    if len({tuple(v[0]) for v in out.values()}) != 1:
        raise AssertionError(f"trace: the traced generate's tokens differ: "
                             f"{[v[0] for v in out.values()]}")
    spans = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    own = {name: sum(name in k for k in kernels) for name in OWN_KERNELS}
    n_pre, n_dec = spans.count(Trace.SPAN_PREFILL), spans.count(
        Trace.SPAN_DECODE)
    if (n_pre, n_dec) != (2, 16 // engine.horizon) or not (
            own["qmm_gemv_kernel"] and own["flash_prefill_kernel"]
            and own["flash_decode_kernel"]):
        raise AssertionError(f"trace: spans prefill {n_pre}, decode_step "
                             f"{n_dec}; the port's kernels {own}")
    return {"phase": "trace", "card": card_line(), "spans_prefill": n_pre,
            "spans_decode_step": n_dec, "kernel_events": len(kernels),
            "own_kernel_events": own, "trace_mb": trace_mb,
            "decode_tok_s_untraced": out["untraced"][1],
            "decode_tok_s_traced": out["traced"][1],
            "decode_tok_s_untraced_again": out["untraced again"][1],
            "paged_tick": ticks}


# perplexity on the kernels against the plain twins on the card: a row's
# log-probability moves by at most twice its logits' error (the token's
# logit and the log-sum), which LOGIT_REL bounds at 1e-2 of their range;
# each row within LOGP_SHARE of its magnitude, so the log-perplexity, the
# rows' mean, within LOGP_SHARE of its own (random weights give ln ppl ~
# 70: a relative gap of the perplexity itself scales with it)
LOGP_SHARE = 1e-2
# each layer's residual stream on the kernels against the twins' (and on
# the card against the CPU): bf16 roundings that fall the other way
# (LOGIT_REL's reason) leave the directions all but equal
DUMP_COS = 0.999


def phase_tools_full_width(dev: torch.device, cfg, model) -> dict:
    """tools/perplexity.py and tools/dump_activations.py on llama-8b
    (32 layers, Q4_K): token_log_probs over 490 seeded ids at batch 32
    (15 chunks of 32 rows on the prefill kernels and the lm_head's
    prefill GEMM, a last chunk of 10 on flash-decode and the fused head)
    and at batch 512 (one chunk of 490), each timed, its launches zeroed
    before and read after, the four kernels required at batch 32; 74 ids
    at batch 32 (chunks of 32, 32 and 10) on the kernels and on the plain
    twins on the card, each row's log-probability and the log-perplexity
    within LOGP_SHARE of their magnitudes; dump_forward of 64
    ids on the kernels and on the twins, every layer's cosine >= DUMP_COS
    and the logits by the near-tie rule."""
    import numpy as np

    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.tools.cos_sim import compare
    from powerserve_tpu_torch.tools.dump_activations import dump_forward
    from powerserve_tpu_torch.tools.perplexity import (PerplexityCalculator,
                                                       token_log_probs)

    t_phase = time.perf_counter()
    llm = cfg.llm
    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    ids = torch.randint(3, llm.vocab_size, (490,), generator=g).tolist()

    def ppl(lp: np.ndarray, warmup: int) -> float:
        calc = PerplexityCalculator(warmup)
        calc.add_log_probs(lp)
        return calc.ppl

    token_log_probs(model, ids[:74], 32, max_seq=512)  # allocator warm-up
    runs = {}
    for batch in (32, 512):
        cuda_lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = token_log_probs(model, ids, batch, max_seq=512)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
        need = (("qmatmul", "flash_prefill", "flash_decode", "fused_head")
                if batch == 32 else ("qmatmul", "flash_prefill"))
        if any(not counts.get(k) for k in need) or not np.isfinite(lp).all():
            raise AssertionError(f"tools_full_width batch {batch}: launches "
                                 f"{counts}, finite {np.isfinite(lp).all()}")
        runs[f"batch_{batch}"] = dict(
            seconds=dt, tok_s=len(ids) / dt, launches=counts,
            perplexity_all_rows=ppl(lp, 0))
    twin_ids = ids[:74]
    got = token_log_probs(model, twin_ids, 32, max_seq=128)
    want = step_on(plain_routes(),
                   lambda: token_log_probs(model, twin_ids, 32, max_seq=128))
    share = float((np.abs(got - want) / np.abs(want)).max())
    p_got, p_want = ppl(got, 32), ppl(want, 32)
    log_gap = abs(math.log(p_got) - math.log(p_want)) / math.log(p_want)
    if not (share <= LOGP_SHARE and log_gap <= LOGP_SHARE):
        raise AssertionError(f"tools_full_width: log-probabilities within "
                             f"{share} of the twins', perplexity {p_got} "
                             f"against {p_want}")
    with tempfile.TemporaryDirectory() as tmp:
        a = dump_forward(model, ids[:64], os.path.join(tmp, "kernels"))
        b = step_on(plain_routes(), lambda: dump_forward(
            model, ids[:64], os.path.join(tmp, "twins")))
        rows = compare(a, b)
        layers = [cs for name, cs, _ in rows if name.startswith("layer_")]
        logits = [np.load(d / "logits.npy") for d in (a, b)]
    if len(layers) != llm.n_layers or min(layers) < DUMP_COS:
        raise AssertionError(f"tools_full_width dumps: cosines {layers}")
    gap = near_tie_agree("tools_full_width dump logits",
                         torch.from_numpy(logits[0]),
                         torch.from_numpy(logits[1]))
    return {"phase": "tools_full_width", "card": card_line(),
            "seconds": time.perf_counter() - t_phase,
            "tokens": len(ids), **runs,
            "twins": dict(tokens=len(twin_ids), chunks=[32, 32, 10],
                          max_row_share=share, perplexity=p_got,
                          twin_perplexity=p_want,
                          perplexity_rel_gap=abs(p_got - p_want) / p_want,
                          log_perplexity_gap=log_gap,
                          share_limit=LOGP_SHARE),
            "dump": dict(tokens=64, min_layer_cos=min(layers),
                         logits_cos=rows[-1][1], logit_gap=gap)}


def write_bpe_tokenizer(d: str, text: str) -> None:
    """A byte-level BPE tokenizer.json trained on `text` (300 tokens) and
    its tokenizer_config.json, in d."""
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([text] * 8, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>",
                   "add_bos_token": True}, f)


def write_hf_llama(d: str, dev: torch.device, layers: int, vocab: int,
                   widths: tuple = (4096, 14336, 32, 8)) -> None:
    """An HF directory as a Llama-3.1-8B checkpoint has it (config.json,
    BF16 model.safetensors written by the port's tools/safetensors.py, a
    byte-level BPE tokenizer.json and tokenizer_config.json), cut to
    `layers` layers and a `vocab`-token vocabulary, random weights from
    seed 8; widths (dim, ffn, heads, kv heads) llama-8b's."""
    from powerserve_tpu_torch.tools.safetensors import save_file

    dim, ff, H, Hkv = widths
    hd = dim // H
    g = torch.Generator(device=dev)
    g.manual_seed(8)

    def w(*shape, one=False):
        t = torch.randn(shape, generator=g, device=dev) * (0.1 if one
                                                            else 0.02)
        return (t + 1 if one else t).bfloat16().cpu()

    sd = {"model.embed_tokens.weight": w(vocab, dim),
          "model.norm.weight": w(dim, one=True),
          "lm_head.weight": w(vocab, dim)}
    for i in range(layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w(dim, one=True),
            p + "post_attention_layernorm.weight": w(dim, one=True),
            p + "self_attn.q_proj.weight": w(H * hd, dim),
            p + "self_attn.k_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.v_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.o_proj.weight": w(dim, H * hd),
            p + "mlp.gate_proj.weight": w(ff, dim),
            p + "mlp.up_proj.weight": w(ff, dim),
            p + "mlp.down_proj.weight": w(dim, ff)})
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "hidden_size": dim, "intermediate_size": ff,
                   "num_hidden_layers": layers, "num_attention_heads": H,
                   "num_key_value_heads": Hkv,
                   "max_position_embeddings": 1024, "rope_theta": 500000.0,
                   "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                                    "high_freq_factor": 4.0,
                                    "original_max_position_embeddings": 8192,
                                    "rope_type": "llama3"},
                   "rms_norm_eps": 1e-5, "vocab_size": vocab,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)
    write_bpe_tokenizer(d, "the quick brown fox jumps over the lazy dog")


def port_cli(cmds: dict, tmp: str, timeout: float = 600) -> dict:
    """Run each of cmds' argvs as `python -m powerserve_tpu_torch argv`
    from the checkout's root, all at once; {name: (stdout, seconds from
    the start to its exit)}. A non-zero exit raises with its stderr's end.
    Processes still running on a failure get SIGINT (the gate then kills
    its server in its `finally`), then SIGKILL."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs, files, ends = {}, {}, {}
    try:
        for name, argv in cmds.items():
            files[name] = tuple(open(os.path.join(tmp, f"{name}.{ext}"),
                                     "w+") for ext in ("out", "err"))
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "powerserve_tpu_torch", *argv],
                stdout=files[name][0], stderr=files[name][1], cwd=root)
        while len(ends) < len(procs):
            if time.perf_counter() - t0 > timeout:
                left = sorted(set(procs) - set(ends))
                raise AssertionError(f"tools_cli: {left} still running "
                                     f"after {timeout} s")
            for name, proc in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        files[name][1].seek(0)
                        raise AssertionError(
                            f"{cmds[name][0]} exited {proc.returncode}: "
                            f"{files[name][1].read()[-3000:]}")
            time.sleep(0.1)
        out = {}
        for name, (fo, _) in files.items():
            fo.seek(0)
            out[name] = (fo.read(), ends[name])
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for fo, fe in files.values():
            fo.close()
            fe.close()


def phase_tools_cli(dev: torch.device) -> dict:
    """The tools as `python -m powerserve_tpu_torch` processes on the card,
    over an HF directory at llama-8b's widths (2 layers, a 32,000-token
    vocabulary, BF16, write_hf_llama): convert --quant q8_0 and workspace
    create; then at once perplexity, dump-activations on the card, run
    --dump-speedinfo, param-search over CHAIN_GRID with a 1-layer
    self-draft, gate (a corpus, --draft self:1, a 4-question MMLU CSV
    against the server it starts) and bench-kernels (its six lines);
    then dump-activations --device cpu and cos-sim of the two dumps
    (every layer >= DUMP_COS). Each must exit 0; the speed-info line is
    read back. Seconds of each (those run at once share the card and the
    host: their speeds are not measurements). Two cuts for the script's
    time, printed: convert quantizes to Q8_0 (Q4_K's k-quant search took
    the longer part of its 30-38 s), and bench-kernels runs beside the
    others, not alone."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tools_cli_")
    secs = {}
    try:
        hf, out, ws = (os.path.join(tmp, n) for n in ("hf", "out", "ws"))
        t0 = time.perf_counter()
        write_hf_llama(hf, dev, layers=2, vocab=32000)
        secs["write_hf"] = time.perf_counter() - t0
        model_dir = os.path.join(out, "model")
        for name, argv in (("convert", ["convert", hf, out, "--quant",
                                        "q8_0"]),
                           ("workspace", ["workspace", "create", "-m",
                                          model_dir, "-o", ws])):
            secs[name] = port_cli({name: argv}, tmp)[name][1]
        if not os.path.exists(os.path.join(model_dir, "tokenizer.json")):
            raise AssertionError("convert: tokenizer.json not copied")
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w") as f:
            f.write("The quick brown fox jumps over the lazy dog while the "
                    "lazy dog sleeps under the brown tree. " * 14)
        mmlu_dir = os.path.join(tmp, "mmlu")
        os.makedirs(mmlu_dir)
        with open(os.path.join(mmlu_dir, "arith_test.csv"), "w") as f:
            f.write("What is 1+1?,1,2,3,4,B\nWhat is 2+2?,3,4,5,6,B\n"
                    "What is 3+3?,6,7,8,9,A\nWhat is 4+4?,5,6,7,8,D\n"
                    "What is 5+5?,9,10,11,12,B\n")
        dumps = {d: os.path.join(tmp, f"dump_{d}") for d in ("cuda", "cpu")}
        speed, search, gate_json = (os.path.join(tmp, n) for n in (
            "speed.jsonl", "search.jsonl", "gate.json"))
        text = "the quick brown fox jumps over the lazy dog"
        dump = {d: ["dump-activations", "-d", model_dir, "-p", text, "-o",
                    dumps[d], "--device", d] for d in dumps}
        together = {
            "perplexity": ["perplexity", "-d", model_dir, "-p", corpus],
            "dump_activations_cuda": dump["cuda"],
            "run": ["run", "-d", ws, "-p", "the quick brown", "-n", "16",
                    "--temperature", "0", "--no-progress",
                    "--dump-speedinfo", speed],
            "param_search": ["param-search", "-d", model_dir, "--engine",
                             "chain", "--self-draft-layers", "1", "-n", "32",
                             "-o", search],
            "gate": ["gate", "-d", ws, "--prompt-file", corpus, "--draft",
                     "self:1", "--spec-tokens", "32", "--mmlu-data",
                     mmlu_dir, "--mmlu-limit", "4", "-o", gate_json],
            "bench_kernels": ["bench-kernels", "--iters", "200"]}
        t0 = time.perf_counter()
        res = port_cli(together, tmp)
        secs["together"] = time.perf_counter() - t0
        secs.update({name: r[1] for name, r in res.items()})
        ppl = json.loads(res["perplexity"][0].strip().splitlines()[-1])
        if set(ppl) != {"perplexity", "n_tokens"} or not (
                1 < ppl["perplexity"] < float("inf")):
            raise AssertionError(f"perplexity: {ppl}")
        with open(speed) as f:
            speedinfo = json.loads(f.read().strip().splitlines()[-1])
        if list(speedinfo) != ["prefill_speed", "decode_speed", "n_prefill",
                               "n_decode"] or not speedinfo["n_decode"]:
            raise AssertionError(f"run --dump-speedinfo: {speedinfo}")
        with open(search) as f:
            recs = [json.loads(ln) for ln in f]
        if [r["k"] for r in recs] != [3, 4, 6] or any(
                r["emitted"] != 32 for r in recs):
            raise AssertionError(f"param-search: {recs}")
        with open(gate_json) as f:
            verdict = json.load(f)
        if not verdict["pass"] or verdict["checks"]["mmlu"]["total_n"] != 4:
            raise AssertionError(f"gate: {verdict}")
        # the CPU forward's threads would take the host from the others
        secs["dump_activations_cpu"] = port_cli(
            {"dump": dump["cpu"]}, tmp)["dump"][1]
        cos_out, secs["cos_sim"] = port_cli(
            {"cos_sim": ["cos-sim", dumps["cuda"], dumps["cpu"]]},
            tmp)["cos_sim"]
        cos = {ln.split(":")[0]: float(ln.split("cos=")[1].split()[0])
               for ln in cos_out.strip().splitlines()}
        layers = [v for k, v in cos.items() if k.startswith("layer_")]
        if len(layers) != 2 or min(layers) < DUMP_COS:
            raise AssertionError(f"cos-sim cuda vs cpu: {cos}")
        bench = [json.loads(ln) for ln in
                 res["bench_kernels"][0].strip().splitlines()]
        if len(bench) != 6:
            raise AssertionError(f"bench-kernels: {bench_out}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "tools_cli", "card": card_line(),
            "phase_seconds": time.perf_counter() - t_phase,
            "hf": dict(widths="llama-8b", layers=2, vocab=32000,
                       dtype="bf16"),
            "cuts": {"convert": "--quant q4_k -> q8_0",
                     "bench_kernels": "alone on the card -> beside the "
                                      "other tools (its speeds are not "
                                      "measurements)"},
            "seconds": secs, "perplexity": ppl, "cos_cuda_cpu": cos,
            "speedinfo": speedinfo, "param_search": recs,
            "gate": verdict["checks"], "bench_kernels": bench}


def random_q4k(rng, n_out: int, k_in: int):
    """A Q4_K payload [n_out, k_in] of random bytes with finite block
    scales (fp16 d and dmin in [0, 0.01))."""
    import numpy as np

    nb = k_in // 256
    blocks = rng.integers(0, 256, (n_out, nb, 144), dtype=np.uint8)
    d = (rng.random((n_out, nb, 2), dtype=np.float32) * 0.01).astype(
        np.float16)
    blocks[..., :4] = d.view(np.uint8).reshape(n_out, nb, 4)
    return blocks.reshape(-1)


def phase_native(dev: torch.device) -> dict:
    """The native host runtime (core/native.py): load_gguf_model of a
    llama-8b-width Q4_K GGUF the script writes (random blocks; cut to 4
    layers and a 32,000-token tied vocabulary) onto the card with the
    C++ repack and with the numpy twin (core/quant.py): every weight bit
    for bit, the seconds of each (the file in the page cache: warm);
    then the tokenization of a ~2,048-token prompt on a 32k vocabulary of
    random words and their pieces, by the C++ merge loop and by the
    Python loop: the same ids, the ms of each."""
    import random
    from unittest import mock

    import numpy as np

    from powerserve_tpu_torch.core import native
    from powerserve_tpu_torch.core.gguf import GGMLType, GGUFWriter
    from powerserve_tpu_torch.models import loader
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tokenizer.vocab import GGUFVocab
    from powerserve_tpu_torch.tools.synthetic import _simple_vocab

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    dim, ffn, L, H, Hkv, V = 4096, 14336, 4, 32, 8, 32000
    hd = dim // H
    rng = np.random.default_rng(0)
    w = GGUFWriter()
    md = w.metadata
    for key, val in (("embedding_length", dim), ("feed_forward_length", ffn),
                     ("block_count", L), ("attention.head_count", H),
                     ("attention.head_count_kv", Hkv),
                     ("context_length", 2048), ("rope.dimension_count", hd),
                     ("rope.freq_base", 500000.0),
                     ("attention.layer_norm_rms_epsilon", 1e-5),
                     ("vocab_size", V)):
        md[f"llama.{key}"] = val
    md["general.architecture"] = "llama"
    toks, scores, types = _simple_vocab(V)
    md.update({"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
               "tokenizer.ggml.scores": scores,
               "tokenizer.ggml.token_type": types})

    def q4k(name, n_out, k_in):
        w.add_tensor(name, (k_in, n_out), GGMLType.Q4_K,
                     random_q4k(rng, n_out, k_in))

    q4k("token_embd.weight", V, dim)
    w.add_float_tensor("output_norm.weight", np.ones(dim, np.float32))
    for i in range(L):
        pre = f"blk.{i}."
        for name in ("attn_norm", "ffn_norm"):
            w.add_float_tensor(pre + name + ".weight",
                               np.ones(dim, np.float32))
        for name, n_out, k_in in (("attn_q", H * hd, dim),
                                  ("attn_k", Hkv * hd, dim),
                                  ("attn_v", Hkv * hd, dim),
                                  ("attn_output", dim, H * hd),
                                  ("ffn_gate", ffn, dim),
                                  ("ffn_up", ffn, dim),
                                  ("ffn_down", dim, ffn)):
            q4k(f"{pre}{name}.weight", n_out, k_in)
    result = {"phase": "native", "card": card_line(), "build_s": build_s,
              "gguf": {"dim": dim, "ffn": ffn, "heads": H, "kv_heads": Hkv,
                       "layers": L, "vocab": V, "quant": "q4_k",
                       "reduced": ["layers 32 -> 4",
                                   "vocab 128256 -> 32000, tied"]}}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/weights.gguf"
        w.write(path)
        del w
        result["gguf"]["bytes"] = os.path.getsize(path)
        loads = {}
        for label in ("native", "numpy"):
            with (mock.patch.object(loader, "native_repack",
                                    lambda *a: None)
                  if label == "numpy" else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = loader.load_gguf_model(path, device=dev)
                torch.cuda.synchronize()
                loads[label] = (time.perf_counter() - t0, m.state_dict())
        a, b = loads["native"][1], loads["numpy"][1]
        if a.keys() != b.keys() or not all(torch.equal(a[n], b[n])
                                           for n in a):
            raise AssertionError("native: the C++ repack's weights differ "
                                 "from the numpy twin's")
        result.update(load_s_native=loads["native"][0],
                      load_s_numpy=loads["numpy"][0], tensors=len(a),
                      bit_equal=True)
        del loads, a, b
    torch.cuda.empty_cache()

    # -- tokenization: random words, each with every prefix (after the
    #    SPM space) and every piece of up to 4 letters in the vocabulary
    rnd = random.Random(0)
    words = ["".join(rnd.choice("abcdefghijklmnopqrstuvwxyz")
                     for _ in range(rnd.randint(3, 9))) for _ in range(3000)]
    pieces = {"▁" + wd[:i] for wd in words for i in range(1, len(wd) + 1)}
    pieces |= {wd[i:j] for wd in words for i in range(len(wd))
               for j in range(i + 1, min(i + 4, len(wd)) + 1)}
    vocab, _, vtypes = _simple_vocab(259)
    vocab += sorted(pieces)[:32000 - 259]
    vtypes += [1] * (len(vocab) - len(vtypes))
    vscores = [0.0] * 259 + [-i * 1e-4 for i in range(len(vocab) - 259)]
    tok = Tokenizer(vocab=GGUFVocab.from_metadata({
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": vocab,
        "tokenizer.ggml.scores": vscores, "tokenizer.ggml.token_type": vtypes,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0}), bos_id=1, eos_id=2,
        stop_ids={2}, add_bos=True)
    text = " ".join(rnd.choice(words) for _ in range(2047))
    ids = tok.tokenize(text)  # the C++ vocab made here
    times = {}
    for label in ("native", "python"):
        v = tok.vocab
        with (mock.patch.multiple(
                v, _spm_encode_fragment=v._spm_encode_fragment_py,
                _bpe_encode_word=v._bpe_encode_word_py)
              if label == "python" else contextlib.nullcontext()):
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = tok.tokenize(text)
                runs.append((time.perf_counter() - t0) * 1e3)
        if got != ids:
            raise AssertionError("native: the C++ merge loop's ids differ "
                                 "from the Python loop's")
        times[label] = statistics.median(runs)
    result.update(tokenize_tokens=len(ids), tokenize_vocab=len(vocab),
                  tokenize_ms_native=times["native"],
                  tokenize_ms_python=times["python"])
    return result


# -- JPEG input, HF InternVL dirs as they are, and MoE (with expert
#    parallelism), VLM and EAGLE over rank groups ------------------------

JPEG_FIXTURE = "progressive_420_896x448.jpg"
# the depth the rank-group compositions cut their models to: full width,
# the first layers of the full model's (the same seed on every rank)
COMPOSE_LAYERS = 8


def jpeg_fixture() -> dict:
    """The committed 896 x 448 progressive 4:2:0 JPEG (tests/data/jpeg,
    written by Pillow) decoded by core/image.py: its pixels' sha256
    against the one recorded from Pillow beside it (this machine has no
    Pillow), and the decode's host ms (median of 5 calls, after a first
    one). Returns {data, pixels, info}."""
    import hashlib

    import numpy as np

    from powerserve_tpu_torch.core.image import decode_image

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "data", "jpeg")
    with open(os.path.join(d, JPEG_FIXTURE), "rb") as f:
        data = f.read()
    with open(os.path.join(d, "expected.json")) as f:
        want = json.load(f)[JPEG_FIXTURE]
    t0 = time.perf_counter()
    pixels = decode_image(data)
    first_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_image(data)
        times.append((time.perf_counter() - t0) * 1e3)
    sha = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
    if sha != want["sha256"] or list(pixels.shape) != want["shape"]:
        raise AssertionError(f"{JPEG_FIXTURE}: decoded {pixels.shape}, sha256 "
                             f"{sha}; Pillow's {want}")
    return dict(data=data, pixels=pixels, info=dict(
        file=f"tests/data/jpeg/{JPEG_FIXTURE}", bytes=len(data),
        shape=list(pixels.shape), pillow_sha256_equal=True,
        decode_ms=statistics.median(times), decode_ms_runs=times,
        first_decode_ms=first_ms))


def chat_image(port: int, url: str, question: str, n_new: int,
               model: str = "model") -> tuple[int, bytes]:
    return http_call(port, "POST", "/v1/chat/completions", {
        "model": model, "max_tokens": n_new, "temperature": 0,
        "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": url}},
            {"type": "text", "text": question}]}]})


def image_urls(fixture: dict) -> dict:
    """The fixture as a data:image/jpeg URI, and the PNG of its decoded
    pixels as a data:image/png one."""
    import base64

    from powerserve_tpu_torch.core.image import encode_png

    return {"jpeg": "data:image/jpeg;base64,"
                    + base64.b64encode(fixture["data"]).decode(),
            "png": "data:image/png;base64," + base64.b64encode(
                encode_png(fixture["pixels"], (1, 4))).decode()}


def write_hf_internvl(d: str, dev: torch.device, text_layers: int = 2,
                      vision_layers: int = 2) -> dict:
    """An HF InternVL checkpoint dir at InternVL2.5-4B's widths (the text
    model Qwen2.5-3B's: 2048 wide, FFN 11008, 16/2 heads with QKV biases;
    the tower InternViT-300M-448px's: 1024 wide, FFN 4096, 16 heads, patch
    14, 448-pixel tiles; the projector 4096 -> 2048 -> 2048), cut to
    `text_layers` and `vision_layers` layers, at Qwen2.5-3B's 151,936-token
    vocabulary, untied, with the image-context token at 151,667 (the
    internvl2.5-4b preset of tools/synthetic.py): the
    save_pretrained layout (language_model.model.*, vision_tower.*,
    multi_modal_projector.*) in BF16 by the port's tools/safetensors.py,
    config.json, and a byte-level BPE tokenizer.json; random weights from
    seed 18. Returns the widths."""
    from powerserve_tpu_torch.tools.safetensors import save_file

    dim, ff, H, Hkv, vocab = 2048, 11008, 16, 2, 151936
    vd, vff, vh, patch, image = 1024, 4096, 16, 14, 448
    hd = dim // H
    g = torch.Generator(device=dev)
    g.manual_seed(18)

    def w(*shape, scale=0.02, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + mean).bfloat16().cpu()

    sd = {"language_model.model.embed_tokens.weight": w(vocab, dim),
          "language_model.model.norm.weight": w(dim, scale=0.1, mean=1.0),
          "language_model.lm_head.weight": w(vocab, dim)}
    for i in range(text_layers):
        p = f"language_model.model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w(dim, scale=0.1, mean=1.0),
            p + "post_attention_layernorm.weight": w(dim, scale=0.1,
                                                     mean=1.0),
            p + "self_attn.q_proj.weight": w(H * hd, dim),
            p + "self_attn.q_proj.bias": w(H * hd),
            p + "self_attn.k_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.k_proj.bias": w(Hkv * hd),
            p + "self_attn.v_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.v_proj.bias": w(Hkv * hd),
            p + "self_attn.o_proj.weight": w(dim, H * hd),
            p + "mlp.gate_proj.weight": w(ff, dim),
            p + "mlp.up_proj.weight": w(ff, dim),
            p + "mlp.down_proj.weight": w(dim, ff)})
    n_pos = (image // patch) ** 2 + 1
    sd.update({
        "vision_tower.embeddings.patch_embeddings.projection.weight":
            w(vd, 3, patch, patch),
        "vision_tower.embeddings.patch_embeddings.projection.bias": w(vd),
        "vision_tower.embeddings.cls_token": w(1, 1, vd),
        "vision_tower.embeddings.position_embeddings": w(1, n_pos, vd)})
    for i in range(vision_layers):
        p = f"vision_tower.encoder.layer.{i}."
        for n in "qkv":
            sd[p + f"attention.{n}_proj.weight"] = w(vd, vd)
            sd[p + f"attention.{n}_proj.bias"] = w(vd, scale=0.01)
        sd.update({
            p + "attention.projection_layer.weight": w(vd, vd),
            p + "attention.projection_layer.bias": w(vd, scale=0.01),
            p + "mlp.fc1.weight": w(vff, vd), p + "mlp.fc1.bias": w(vff),
            p + "mlp.fc2.weight": w(vd, vff), p + "mlp.fc2.bias": w(vd),
            p + "layernorm_before.weight": w(vd, scale=0.1, mean=1.0),
            p + "layernorm_before.bias": w(vd, scale=0.01),
            p + "layernorm_after.weight": w(vd, scale=0.1, mean=1.0),
            p + "layernorm_after.bias": w(vd, scale=0.01),
            p + "lambda_1": w(vd, scale=0.01, mean=0.1),
            p + "lambda_2": w(vd, scale=0.01, mean=0.1)})
    d4 = vd * 4  # pixel shuffle 0.5
    sd.update({"multi_modal_projector.layer_norm.weight": w(d4, scale=0.1,
                                                            mean=1.0),
               "multi_modal_projector.layer_norm.bias": w(d4, scale=0.01),
               "multi_modal_projector.linear_1.weight": w(dim, d4),
               "multi_modal_projector.linear_1.bias": w(dim, scale=0.01),
               "multi_modal_projector.linear_2.weight": w(dim, dim),
               "multi_modal_projector.linear_2.bias": w(dim, scale=0.01)})
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))
    text = {"model_type": "qwen2", "hidden_size": dim,
            "intermediate_size": ff, "num_hidden_layers": text_layers,
            "num_attention_heads": H, "num_key_value_heads": Hkv,
            "max_position_embeddings": 4096, "rope_theta": 1000000.0,
            "rms_norm_eps": 1e-6, "vocab_size": vocab,
            "tie_word_embeddings": False}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["InternVLForConditionalGeneration"],
                   "text_config": text,
                   "vision_config": {"hidden_size": vd,
                                     "intermediate_size": vff,
                                     "num_hidden_layers": vision_layers,
                                     "num_attention_heads": vh,
                                     "patch_size": [patch, patch],
                                     "image_size": [image, image],
                                     "layer_norm_eps": 1e-6},
                   "downsample_ratio": 0.5, "image_token_id": 151667,
                   "image_seq_length": 256, "torch_dtype": "bfloat16"}, f)
    write_bpe_tokenizer(d, "describe the picture and count the stripes")
    return dict(text_layers=text_layers, vision_layers=vision_layers,
                dim=dim, ffn=ff, heads=(H, Hkv), vocab=vocab,
                vision_dim=vd, vision_ffn=vff, tensors=len(sd),
                bytes=sum(t.numel() * 2 for t in sd.values()))


def phase_vlm_hf_dir(dev: torch.device) -> dict:
    """An HF InternVL checkpoint dir at InternVL2.5-4B's widths and
    vocabulary, 2 text and 2 vision layers (write_hf_internvl), loaded as
    it is: `run --image <the JPEG fixture> -d <hf dir>` (the text
    weights quantized to Q8_0 in memory, models/internvl.py
    internvl_from_hf_dir) against
    `run` on the workspace `convert --quant q8_0` writes of the same dir:
    the same greedy tokens (the same Q8_0 blocks of the same values, the
    same f32 tower), each run's launches counted. Both in this process
    (run.run_prompt on parse_args, the CLI's own path); seconds of each
    step."""
    import io

    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.tools import convert_hf

    out: dict = {"phase": "vlm_hf_dir", "card": card_line()}
    secs = {}
    tmp = tempfile.mkdtemp(prefix="vlm_hf_")
    try:
        hf, ws = os.path.join(tmp, "hf"), os.path.join(tmp, "ws")
        t0 = time.perf_counter()
        out["hf"] = write_hf_internvl(hf, dev)
        secs["write_hf"] = time.perf_counter() - t0
        fixture = jpeg_fixture()
        img = os.path.join(tmp, "a.jpg")
        with open(img, "wb") as f:
            f.write(fixture["data"])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_hf.main([hf, ws, "--quant", "q8_0"])
        secs["convert"] = time.perf_counter() - t0
        need = ("qmatmul", "fused_head", "flash_prefill", "flash_decode")
        runs = {}
        for label, d in (("hf_dir", hf), ("workspace", ws)):
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = run.run_prompt(run.parse_args([
                    "-d", d, "-p", "describe the picture", "-n", "16",
                    "--temperature", "0", "--image", img,
                    "--no-progress"]))
            torch.cuda.synchronize()
            secs[f"run_{label}"] = time.perf_counter() - t0
            launches = cuda_lib.launch_counts()
            missing = [k for k in need if not launches[k]]
            if missing:
                raise AssertionError(f"vlm_hf_dir {label}: no {missing}")
            runs[label] = dict(ids=res.ids, prompt_tokens=len(res.prompt_ids),
                               launches={k: launches[k] for k in need})
        if runs["hf_dir"]["ids"] != runs["workspace"]["ids"] or len(
                runs["hf_dir"]["ids"]) != 16:
            raise AssertionError(f"run --image on the HF dir "
                                 f"{runs['hf_dir']['ids']} != on its "
                                 f"workspace {runs['workspace']['ids']}")
        out.update(runs=runs, tokens_equal=True, seconds=secs,
                   jpeg=fixture["info"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# the serving settings of the rank-group compositions, on one device and
# over the ranks alike
COMPOSE_HP = dict(max_slots=4, batch_size=128, max_seq_len=2048)


@contextlib.contextmanager
def compose_context(dev: torch.device):
    """One ServerContext over TP ranks (two ranks, gloo on the one card or
    nccl on two) that the rank-group phases share: each registers its
    models on the context's ranks (ep = 2 builds on the same ranks'
    (tp = 1, ep = 2) mesh), so the followers start once."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.serving.server import ServerContext

    backend, _ = tp_backend()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = ServerContext(tmp, "model", HyperParams(**COMPOSE_HP),
                            dev.type, tp=TP, dist_backend=backend)
        ctx.start_s = time.perf_counter() - t0
        try:
            yield ctx
        finally:
            ctx.close()


def phase_tp_moe_kernels(dev: torch.device) -> dict:
    """The grouped qmatmul at mixtral-lite's local expert shapes over a
    rank group, against its twin on the card with CUDA-event times and
    bounds (the kernels phase's rule): tp = 2 (rows 2tp: 8 slabs of
    4096 -> 1792 for gate and up, 1792 -> 4096 for down, pack group
    1792) and ep = 2 (rows 2ep: 4 slabs of 4096 -> 3584 and 3584 ->
    4096, the ep rank's share of the routed rows, e_off 4); a 256-token
    prefill (block_m 128), 8 decoding slots (block_m 16) and, at tp = 2,
    one token (block_m 1, its 2 routed slabs); twice bit for bit."""
    from powerserve_tpu_torch.ops.moe import group_dispatch
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_grouped_cuda,
                                                  qmatmul_grouped_reference)
    from powerserve_tpu_torch.parallel.tp import _repack_rows, _rows
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    timer = Timer(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    rows = []
    for mesh, E, n_local, e_off, shapes in (
            ("tp2", 8, 8, 0, (("gate", 4096, 1792), ("down", 1792, 4096))),
            ("ep2", 8, 4, 4, (("gate", 4096, 3584), ("down", 3584, 4096)))):
        for proj, K, N in shapes:
            if mesh == "tp2" and proj == "down":
                # the down slabs as shard_params_tp leaves them: rank 1's
                # rows of the repacked 3584 -> 4096 stack
                whole = _rand_qlinear(g, 2 * K, N, "q4_k", dev, experts=E)
                stack = _rows(_repack_rows(whole, 2), 1, 2)
                del whole
            else:
                stack = _rand_qlinear(g, K, N, "q4_k", dev, experts=n_local)
            for n_tok, bm in ((256, 128), (8, 16), (1, 1)):
                if bm == 1 and mesh == "ep2":
                    continue  # under ep a token takes the grouped route
                logits = torch.randn(n_tok, E, generator=g, device=dev)
                topw, topi = torch.softmax(logits, dim=-1).topk(2, dim=-1)
                # the rows routed to this rank's experts, and their slabs
                mine = topi[(topi >= e_off) & (topi < e_off + n_local)]
                routed, distinct = mine.numel(), int(mine.unique().numel())
                if bm == 1:
                    ids = topi[0].to(torch.int32)
                    x = (torch.randn(1, K, generator=g, device=dev)
                         .to(torch.bfloat16).expand(2, K).contiguous())
                else:
                    tok, _, ids = group_dispatch(topi, topw, n_local, e_off,
                                                 bm)
                    x = torch.randn(n_tok, K, generator=g, device=dev).to(
                        torch.bfloat16)[tok.clamp(min=0).long()]
                name = f"{mesh} qmatmul_grouped {proj} {n_tok} tokens"
                ref = qmatmul_grouped_reference(x, stack, ids, bm)
                got = qmatmul_grouped_cuda(x, stack, ids, bm)
                err = (got - ref).abs().max().item()
                tol = 1e-4 * max(1.0, ref.abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{name}: max abs err {err} over "
                                         f"{tol}")
                if not torch.equal(got, qmatmul_grouped_cuda(x, stack, ids,
                                                             bm)):
                    raise AssertionError(f"{name}: two runs gave different "
                                         f"bits")
                b, by = bound_ms(routed * K * 2 + nbytes(ids)
                                 + distinct * stack.nbytes() // n_local
                                 + routed * N * 4, 2.0 * routed * N * K)
                rows.append(dict(
                    kernel="qmatmul_grouped", mesh=mesh, proj=proj,
                    tokens=n_tok, block_m=bm, slabs=n_local, k=K, n=N,
                    pack_group=stack.pack_group, P=x.shape[0],
                    routed_rows=routed, distinct_slabs=distinct,
                    max_abs_err=err,
                    ms=timer(lambda: qmatmul_grouped_cuda(x, stack, ids,
                                                          bm)),
                    plain_ms=timer(lambda: qmatmul_grouped_reference(
                        x, stack, ids, bm), reps=5),
                    bound_ms=b, bound_by=by, library_ms=None))
            del stack
    return {"phase": "tp_moe_kernels", "rows": rows}


def phase_tp_moe_full_width(dev: torch.device, ctx) -> dict:
    """mixtral-lite Q4_K (8 experts of 3584, top-2; random weights from
    seed 0 on every rank) cut to COMPOSE_LAYERS layers, over the two
    ranks of ctx (compose_context): tp = 2 (every expert stack split like
    the dense FFN) and ep = 2, tp = 1 (4 experts a rank). Each: a
    256-token prefill (the grouped route at 128-row tiles) and a
    one-token decode step (the single-token route at tp = 2, the grouped
    one under ep) held against the single device's logits (TP_LOGIT_REL,
    the greedy token up to a near-tie), 16 greedy tokens over the ranks
    against generate's (near-tie rule), then serve_run's traffic to the
    model registered on ctx against the single-device server's tokens
    (near-tie rule). Every rank's launches of each path."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.parallel.tp import (tp_decode_scan, tp_forward,
                                                  tp_prefill)
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    backend, how = tp_backend()
    group = ctx.ranks
    L = COMPOSE_LAYERS
    cfg, model = make_device_params("mixtral-lite", "q4_k", seed=0,
                                    device=dev, layers=L)
    llm = cfg.llm
    n_prompt, n_tokens, max_seq = 256, 16, 1024
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=max_seq)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    want_tokens = list(engine.generate(prompt.tolist(), n_tokens))
    tok = synthetic_tokenizer(llm.vocab_size)
    shp = HyperParams(**COMPOSE_HP)
    with tempfile.TemporaryDirectory() as tmp:
        one = ServerContext(tmp, "moe", shp, dev)
        try:
            one.register("moe", model, cfg, tok)
            served_one = serve_run(None, shp, dev.type, "moe", ctx=one)
        finally:
            one.close()
    out: dict = {"phase": "tp_moe_full_width", "preset": "mixtral-lite",
                 "layers": L, "backend": backend, "ranks": how,
                 "rank_group_start_s": ctx.start_s, "card": card_line()}
    need = ("qmatmul", "qmatmul_grouped", "fused_head")
    for label, tp, ep in (("tp2", 2, 1), ("ep2", 1, 2)):
        res: dict = {}
        t0 = time.perf_counter()
        _, tm = group.preset("mixtral-lite", "q4_k", 0, tp, ep=ep, layers=L)
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
        lw = tm.shard.model.layers[0]
        res["local_shapes"] = dict(
            experts=lw.w_gate_exps.n_slabs,
            gate_up=lw.w_gate_exps.out_features,
            down_k=lw.w_down_exps.in_features,
            down_pack_group=lw.w_down_exps.pack_group,
            heads=(tm.shard.model.llm.n_heads, tm.shard.model.llm.n_kv_heads))
        E, F = llm.n_experts, llm.hidden_dim
        if (lw.w_gate_exps.n_slabs, lw.w_gate_exps.out_features,
                lw.w_down_exps.in_features) != (E // ep, F // tp, F // tp):
            raise AssertionError(f"{label} shards: {res['local_shapes']}")
        kv1 = KVCache.create(L, 1, max_seq, llm.n_kv_heads, llm.head_size,
                             dev)
        kv2 = tm.create_cache(L, 1, max_seq, llm.n_kv_heads, llm.head_size)
        toks = prompt[None].to(dev)
        pos = torch.arange(n_prompt, device=dev)[None]
        counts = {}

        def timed(name, fn):
            group.launch_counts(reset=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            res[f"{name}_wall_s"] = time.perf_counter() - t
            counts[name] = rank_counts(group.launch_counts(), need,
                                       f"{label} {name}")
            return r

        want = model(kv1, toks, pos, logits_mode="last")
        got = timed("prefill", lambda: tp_prefill(tm, toks, pos, kv2))
        res["prefill_logit_gap"] = tp_agree(f"{label} prefill", got, want)
        first = want.argmax(-1)
        dpos = torch.full((1, 1), n_prompt, device=dev)
        want_d = model(kv1, first[:, None], dpos, logits_mode="last")
        got_d = timed("decode_step", lambda: tp_forward(
            tm, kv2, first[:, None], dpos, logits_mode="last"))
        res["decode_step_logit_gap"] = tp_agree(f"{label} decode step",
                                                got_d, want_d)
        scan = timed("decode_scan", lambda: tp_decode_scan(
            tm, got_d.argmax(-1), kv2, n_tokens - 2))
        got_tokens = ([int(got.argmax(-1)), int(got_d.argmax(-1))]
                      + scan[0].tolist())
        res["decode_tok_s"] = (n_tokens - 2) / res["decode_scan_wall_s"]
        res["near_tie_gap"] = agree(f"{label} greedy vs generate",
                                    got_tokens, want_tokens, engine,
                                    prompt.tolist())
        res["tokens_equal"] = got_tokens == want_tokens
        del kv2
        name = f"moe_{label}"
        ctx.register(name, tm, cfg, tok)
        t0 = time.perf_counter()
        served = serve_run(None, shp, dev.type, name, ctx=ctx)
        res["served_s"] = time.perf_counter() - t0
        gaps = []
        for p, ids in served["all_tokens"]:
            gaps.append(agree(f"{label} served vs one device", ids,
                              served_one["tokens"][p], engine, list(p)))
        res["served_texts"] = served["texts"]
        res["served_near_ties"] = [x for x in gaps if x is not None]
        res["served_rank_launches"] = rank_counts(
            served["rank_launches"], need, f"{label} served")
        res["launches"] = counts
        out[label] = res
    return out


def phase_serve_tp_vlm(dev: torch.device, ctx) -> dict:
    """The HTTP server over ctx's two ranks (tp = 2) with an InternVL2.5-4B-width
    VLM (random weights; the text model cut to COMPOSE_LAYERS layers over
    the ranks, the whole tower on rank 0's card): one chat request with
    the JPEG fixture (as data:image/jpeg) and one text completion at
    once, 16 greedy tokens each; each reply is the single-device server's
    with the same model (near-tie rule: the image reply's by its
    multimodal prefill, the text reply's by generate's prefill), with
    each rank's launches."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.vlm import VLMEngine
    from powerserve_tpu_torch.models.internvl import InternVLModel
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tools.bench_params import make_device_internvl
    from powerserve_tpu_torch.tools.synthetic import VLM_PRESETS

    backend, how = tp_backend()
    n_new = 16
    vlm = make_device_internvl(VLM_PRESET, "q4_k", seed=0, device=dev,
                               text_layers=COMPOSE_LAYERS)
    tok = synthetic_tokenizer(vlm.cfg.llm.vocab_size)
    fixture = jpeg_fixture()
    url = image_urls(fixture)["jpeg"]
    hp = HyperParams(**COMPOSE_HP)
    need = ("qmatmul", "fused_head", "flash_prefill", "flash_decode")

    def traffic(ctx, name) -> tuple[dict, list | None]:
        server = serving(ctx)
        port = server.server_address[1]
        try:
            calls = [lambda: chat_image(port, url, "describe the picture",
                                        n_new, model=name),
                     lambda: http_call(port, "POST", "/v1/completions", {
                         "model": name, "prompt": "the quick brown fox",
                         "max_tokens": n_new, "temperature": 0})]
            with ServeRecorder() as rec:
                if ctx.ranks is not None:
                    ctx.ranks.launch_counts(reset=True)
                t0 = time.perf_counter()
                replies = concurrently(calls)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = (None if ctx.ranks is None
                            else ctx.ranks.launch_counts())
            rec.check("serve_tp_vlm")
            for status, data in replies:
                if status != 200:
                    raise AssertionError(f"serve_tp_vlm: {status} "
                                         f"{data[:200]}")
            return dict(tokens=rec.tokens(), wall_s=wall), launches
        finally:
            server.shutdown()
            server.server_close()

    out: dict = {"phase": "serve_tp_vlm", "preset": VLM_PRESET,
                 "text_layers": COMPOSE_LAYERS, "backend": backend,
                 "ranks": how, "jpeg": fixture["info"], "card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        one = ServerContext(tmp, "model", hp, dev)
        try:
            one.register("vlm", vlm.llm, vlm.cfg, tok, vlm=vlm)
            ref, _ = traffic(one, "vlm")
        finally:
            one.close()
    text = VLM_PRESETS[VLM_PRESET][0]
    t0 = time.perf_counter()
    cfg, tm = ctx.ranks.preset(text, "q4_k", 0, TP, layers=COMPOSE_LAYERS)
    out["build_s"] = time.perf_counter() - t0
    tvlm = InternVLModel(vision=vlm.vision, llm=tm, cfg=cfg,
                         image_token_id=vlm.image_token_id,
                         tokens_per_tile=vlm.tokens_per_tile,
                         image_size=vlm.image_size)
    ctx.register("vlm", tm, cfg, tok, vlm=tvlm)
    got, launches = traffic(ctx, "vlm")
    if set(got["tokens"]) != set(ref["tokens"]):
        raise AssertionError("serve_tp_vlm: the prompts over the ranks are "
                             "not one device's")
    px = VLMEngine(vlm, HyperParams(max_seq_len=2048), device=dev
                   ).pixel_values([fixture["pixels"]])
    hp1 = HyperParams(max_slots=1, batch_size=128, max_seq_len=2048)
    hp1.sampler.temperature = 0.0
    engine = InferenceEngine(vlm.llm, vlm.cfg, hp1, device=dev)
    gaps, exact = [], []
    for p, ids in got["tokens"].items():
        want = ref["tokens"][p]
        exact.append(ids == want)
        if p.count(vlm.image_token_id):
            out["image_tokens"] = p.count(vlm.image_token_id)
            gaps.append(mm_agree("serve_tp_vlm image reply", ids, want, vlm,
                                 list(p), px))
        else:
            gaps.append(agree("serve_tp_vlm text reply", ids, want, engine,
                              list(p)))
    out.update(wall_s=got["wall_s"], single_device_wall_s=ref["wall_s"],
               replies_exact=exact,
               near_ties=[x for x in gaps if x is not None],
               rank_launches=rank_counts(launches, need, "serve_tp_vlm"))
    return out


def phase_tp_eagle_full_width(dev: torch.device, group,
                              head_dir: str | None = None) -> dict:
    """llama-8b Q4_K (random weights from seed 0, cut to COMPOSE_LAYERS
    layers) with a random EAGLE-1 head at EAGLE-LLaMA3-8B's widths
    (make_eagle_gguf, seed 4, Q8_0) over two ranks (tp = 2: the head's
    layer split like a target layer, its cache over kv heads, its
    embedding and lm_head the target's vocab shards): the scheduler's
    EAGLE chain (k = 4) and tree ([2, 1, 1]) ticks for two 64-token
    prompts, 24 greedy tokens each, against the single device's
    scheduler with the same head and against generate (near-tie rule);
    then the exact-replica head over the 1-layer target's shards, every
    draft accepted. Every rank's launches of each path."""
    from powerserve_tpu_torch.core.config import HyperParams, ModelConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
    from powerserve_tpu_torch.models.loader import load_eagle_gguf
    from powerserve_tpu_torch.speculative.chain import self_draft_model
    from powerserve_tpu_torch.speculative.eagle import replica_head
    from powerserve_tpu_torch.tools.bench_params import make_device_params
    from powerserve_tpu_torch.tools.synthetic import make_eagle_gguf

    backend, how = tp_backend()
    L, n_new = COMPOSE_LAYERS, 24
    cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev,
                                    layers=L)
    llm = cfg.llm
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    prompts = [torch.randint(3, llm.vocab_size, (64,),
                             generator=g).tolist() for _ in range(2)]
    hp1 = HyperParams(max_slots=1, batch_size=128, max_seq_len=1024)
    hp1.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp1, device=dev)
    plain = [list(engine.generate(p, n_new)) for p in prompts]

    def stepwise(sched) -> list[list[int]]:
        outs, done = [[] for _ in prompts], []
        for o, p in zip(outs, prompts):
            def sink(t, o=o):
                done.append(True) if t is None else o.append(t)

            sched.submit(Request(prompt_ids=list(p), max_tokens=n_new,
                                 temperature=0.0, sink=sink))
        for _ in range(2000):
            if len(done) == len(prompts):
                break
            sched.step()
        if len(done) != len(prompts):
            raise AssertionError("tp_eagle: requests did not finish")
        return outs

    out: dict = {"phase": "tp_eagle_full_width", "layers": L,
                 "backend": backend, "ranks": how, "card": card_line()}
    own = head_dir is None
    if own:  # eagle_full_width's head (the same seed) when it is given
        head_dir = tempfile.mkdtemp(prefix="tp_eagle_head_")
    try:
        if own:
            make_eagle_gguf(head_dir, "llama-8b", GGMLType.Q8_0, seed=4)
        _, head = load_eagle_gguf(head_dir, model, llm, device=dev)
        _, tm = group.preset("llama-8b", "q4_k", 0, TP, layers=L)
        th = group.eagle(tm, head_dir)
        sh = th.shard.head
        out["head_local"] = dict(
            heads=(sh.llm.n_heads, sh.llm.n_kv_heads),
            qkv=sh.layers[0].wqkv.out_features,
            down_k=sh.layers[0].w_down.in_features,
            lm_head=sh.lm_head.out_features)
        for label, kw, need in (
                ("chain", dict(spec_k=4),
                 ("fused_concat2", "qmatmul", "fused_head",
                  "flash_decode", "flash_prefill")),
                ("tree", dict(spec_tree="2,1,1"),
                 ("fused_concat2", "qmatmul", "fused_head",
                  "flash_decode_tree", "flash_prefill"))):
            hp = HyperParams(max_slots=2, batch_size=128,
                             max_seq_len=1024, **kw)
            want = stepwise(BatchScheduler(model, cfg, hp, dev,
                                           eagle_head=head))
            sched = BatchScheduler(tm, cfg, hp, dev, eagle_head=th)
            group.launch_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = stepwise(sched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = rank_counts(group.launch_counts(), need,
                                 f"tp_eagle {label}")
            gaps = [agree(f"tp_eagle {label} vs one device", a, b,
                          engine, p)
                    for a, b, p in zip(got, want, prompts)]
            gaps += [agree(f"tp_eagle {label} vs generate", a, b,
                           engine, p)
                     for a, b, p in zip(got, plain, prompts)]
            m = sched.metrics()
            out[label] = dict(
                wall_s=wall, tokens_equal=got == want,
                near_ties=[x for x in gaps if x is not None],
                spec_steps=sched.n_spec_steps,
                accepted=sched.n_spec_accepted,
                drafted=sched.n_spec_drafted,
                tokens_per_step=m.get("spec_tokens_per_step"),
                rank_launches=counts)
            sched.release()
        # the exact replica over the 1-layer target's shards
        one = group.self_draft(tm, 1)
        rh = group.replica_eagle(one)
        one_cfg = ModelConfig(arch=cfg.arch, llm=one.llm)
        hp = HyperParams(max_slots=2, batch_size=128, max_seq_len=1024,
                         spec_k=4)
        sched = BatchScheduler(one, one_cfg, hp, dev, eagle_head=rh)
        got = stepwise(sched)
        target1 = self_draft_model(model, 1)
        want = stepwise(BatchScheduler(
            target1, one_cfg, HyperParams(max_slots=2, batch_size=128,
                                          max_seq_len=1024), dev,
            eagle_head=replica_head(target1)))
        if sched.n_spec_accepted != sched.n_spec_drafted or not \
                sched.n_spec_drafted:
            raise AssertionError(f"tp_eagle replica: accepted "
                                 f"{sched.n_spec_accepted} of "
                                 f"{sched.n_spec_drafted}")
        engine1 = InferenceEngine(target1, one_cfg, hp1, device=dev)
        gaps = [agree("tp_eagle replica vs one device", a, b, engine1,
                      p) for a, b, p in zip(got, want, prompts)]
        out["replica"] = dict(accept_rate=1.0,
                              drafted=sched.n_spec_drafted,
                              tokens_equal=got == want,
                              near_ties=[x for x in gaps
                                         if x is not None])
        sched.release()
    finally:
        if own:
            shutil.rmtree(head_dir, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import powerserve_tpu_torch  # noqa: F401 — fails outside the repo
    from powerserve_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    cuda_lib.lib()
    ptxas = [ln.strip() for ln in cuda_lib.BUILD_INFO.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": cuda_lib.BUILD_INFO.get("dir"), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})
    if "--kernels" in sys.argv[1:]:
        phase_kernels(dev, read_flush="--read-flush" in sys.argv[1:])
        emit(phase_tp_kernels(dev, read_flush="--read-flush" in sys.argv[1:]))
        print(card, flush=True)
        return 0
    if "--w8" in sys.argv[1:]:
        # the kernels phase and mixtral-lite in W8 alone; a copy of this
        # script in an older tree measures that tree
        phase_kernels(dev)
        emit(phase_w8_moe_full_width(dev)[0])
        print(card, flush=True)
        return 0
    if "--tp" in sys.argv[1:]:
        emit(phase_tp_kernels(dev))
        from powerserve_tpu_torch.tools.bench_params import make_device_params

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        emit(phase_tp_full_width(dev, cfg, model))
        del cfg, model
        torch.cuda.empty_cache()
        emit(phase_serve_tp(dev))
        print(card, flush=True)
        return 0
    if "--pp-sp" in sys.argv[1:]:
        kernels = phase_kernels(dev)
        from powerserve_tpu_torch.core.gguf import GGMLType
        from powerserve_tpu_torch.tools.bench_params import make_device_params
        from powerserve_tpu_torch.tools.synthetic import make_eagle_gguf

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        with pp_sp_context(dev) as ctx, tempfile.TemporaryDirectory(
                prefix="eagle_head_") as head_dir:
            # eagle_full_width's head (the same seed)
            make_eagle_gguf(head_dir, "llama-8b", GGMLType.Q8_0, seed=4)
            sp_full, sm, sp_counts, sp_twin = phase_sp_full_width(dev, ctx)
            emit(sp_full)
            pp_full, pm = phase_pp_full_width(dev, cfg, model, ctx)
            emit(pp_full)
            emit(phase_serve_pp_sp(dev, cfg, model, ctx, pm, sm, sp_twin))
            del pm
            sp_comp, tree_counts = phase_sp_compositions_full_width(
                dev, sp_twin, ctx, sm, head_dir)
            emit(sp_comp)
            del sm, sp_twin
        print(card, flush=True)
        own = {**sp_counts, "flash_decode_state_tree":
               tree_counts["flash_decode_state_tree"]}
        emit({"kernels": [dict(k, launches=own[k["name"]])
                          for k in kernels if k["name"] in own]})
        return 0
    if "--sampled" in sys.argv[1:]:
        # the sampled serving runs and the tick split alone; a copy of
        # this script in an older tree measures that tree (no checks of
        # the in-graph draws where the tree has none)
        import importlib.util

        from powerserve_tpu_torch.tools.bench_params import make_device_params

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        emit(phase_sampled_serve(dev, cfg, model, check=importlib.util.find_spec(
            "powerserve_tpu_torch.ops.sample") is not None)[0])
        print(card, flush=True)
        return 0
    if "--trees" in sys.argv[1:]:
        # the token-tree phases alone, each twice: the first pass also
        # pays the process's first calls (library loads, allocations); a
        # copy of this script in an older tree measures that tree
        from powerserve_tpu_torch.tools.bench_params import make_device_params

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        for pass_ in ("first", "second"):
            emit(dict(phase_tree_full_width(dev, cfg, model)[0], run=pass_))
            emit(dict(phase_serve_full_width(
                dev, cfg, model, "tree_serve_full_width",
                TREE_NEED + ("flash_prefill", "flash_decode_paged_tree"),
                "model+self:4", spec_tree="2,1,1", sampled=True)[0],
                run=pass_))
        print(card, flush=True)
        return 0
    if "--ticks" in sys.argv[1:]:
        from powerserve_tpu_torch.tools.bench_params import make_device_params

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        emit({"phase": "ticks", "card": card,
              **paged_tick_copies(dev, cfg, model)})
        print(card, flush=True)
        return 0
    if "--tools" in sys.argv[1:]:
        from powerserve_tpu_torch.tools.bench_params import make_device_params

        cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
        emit(phase_tools_full_width(dev, cfg, model))
        del cfg, model
        torch.cuda.empty_cache()
        emit(phase_tools_cli(dev))
        print(card, flush=True)
        return 0
    if "--vlm" in sys.argv[1:]:
        torch.zeros(1, device=dev)  # the allocator, before its peak reset
        vlm, vlm_ref = phase_vlm_full_width(dev)
        emit(vlm)
        emit(phase_serve_vlm_full_width(dev, vlm_ref))
        emit(phase_vlm_hf_dir(dev))
        print(card, flush=True)
        return 0
    if "--compose" in sys.argv[1:]:
        emit(phase_tp_kernels(dev))
        emit(phase_tp_moe_kernels(dev))
        with compose_context(dev) as ctx:
            emit(phase_serve_tp_vlm(dev, ctx))
            emit(phase_tp_moe_full_width(dev, ctx))
            emit(phase_tp_eagle_full_width(dev, ctx.ranks))
        emit(phase_vlm_hf_dir(dev))
        print(card, flush=True)
        return 0
    kernels = phase_kernels(dev)
    emit(phase_cli())
    emit(phase_weight_format())
    emit(phase_serve())
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    t0 = time.perf_counter()
    cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "params", "preset": "llama-8b", "quant": "q4_k",
          "build_s": time.perf_counter() - t0})
    full, counts = phase_full_width(dev, cfg, model, "full_width")
    emit(full)
    trace = phase_trace(dev, cfg, model)
    emit(trace)
    tools = phase_tools_full_width(dev, cfg, model)
    emit(tools)
    tools_cli = phase_tools_cli(dev)
    emit(tools_cli)
    serve, serve_counts = phase_serve_full_width(dev, cfg, model,
                                                 "serve_full_width")
    emit(serve)
    sampled, sampled_counts = phase_sampled_serve(dev, cfg, model)
    emit(sampled)
    session = phase_session_full_width(dev, cfg, model)
    emit(session)
    evict = phase_evict(dev)
    emit(evict)
    spec, spec_counts = phase_spec_full_width(dev, cfg, model,
                                              phase_serve_full_width)
    emit(spec)
    tree, tree_counts = phase_tree_full_width(dev, cfg, model)
    emit(tree)
    tree_serve, tree_serve_counts = phase_serve_full_width(
        dev, cfg, model, "tree_serve_full_width",
        TREE_NEED + ("flash_prefill", "flash_decode_paged_tree"),
        "model+self:4",
        spec_tree="2,1,1", reference="serve_full_width", sampled=True)
    emit(tree_serve)
    # the EAGLE head's dir, kept for tp_eagle_full_width (removed at exit
    # if a phase fails first)
    head_tmp = tempfile.TemporaryDirectory(prefix="eagle_head_")
    head_dir = head_tmp.name
    eagle, eagle_counts = phase_eagle_full_width(dev, cfg, model, head_dir)
    emit(eagle)
    eagle_serve, _ = phase_serve_full_width(
        dev, cfg, model, "eagle_serve_full_width",
        ("fused_concat2", "fused_x", "fused_norm", "fused_glu",
         "qmatmul", "flash_decode", "flash_prefill",
         "flash_decode_paged_state"),
        "model+" + head_dir, reference="serve_full_width", sampled=True)
    emit(eagle_serve)
    emit(phase_tp_kernels(dev))
    tp_full = phase_tp_full_width(dev, cfg, model)
    emit(tp_full)
    emit(phase_serve_tp(dev))
    with pp_sp_context(dev) as ctx:
        sp_full, sm, sp_counts, sp_twin = phase_sp_full_width(dev, ctx)
        emit(sp_full)
        pp_full, pm = phase_pp_full_width(dev, cfg, model, ctx)
        emit(pp_full)
        serve_pp_sp = phase_serve_pp_sp(dev, cfg, model, ctx, pm, sm,
                                        sp_twin)
        emit(serve_pp_sp)
        del pm
        sp_comp, sp_tree_counts = phase_sp_compositions_full_width(
            dev, sp_twin, ctx, sm, head_dir)
        emit(sp_comp)
        del sm, sp_twin
    del cfg, model
    torch.cuda.empty_cache()
    vlm, vlm_ref = phase_vlm_full_width(dev)
    emit(vlm)
    serve_vlm = phase_serve_vlm_full_width(dev, vlm_ref)
    emit(serve_vlm)
    del vlm_ref
    torch.cuda.empty_cache()
    vlm_hf = phase_vlm_hf_dir(dev)
    emit(vlm_hf)
    emit(phase_tp_moe_kernels(dev))
    with compose_context(dev) as ctx:
        serve_tp_vlm = phase_serve_tp_vlm(dev, ctx)
        emit(serve_tp_vlm)
        tp_moe = phase_tp_moe_full_width(dev, ctx)
        emit(tp_moe)
        tp_eagle = phase_tp_eagle_full_width(dev, ctx.ranks, head_dir)
        emit(tp_eagle)
    head_tmp.cleanup()
    torch.cuda.empty_cache()
    moe, moe_counts, (cfg, model) = phase_moe_full_width(dev)
    emit(moe)
    serve_moe, _ = phase_serve_full_width(
        dev, cfg, model, "serve_moe_full_width",
        SERVE_NEED + ("qmatmul_grouped",))
    emit(serve_moe)
    del cfg, model
    torch.cuda.empty_cache()
    w8_moe, w8_moe_counts, w8_grouped_rows = phase_w8_moe_full_width(dev)
    emit(w8_moe)
    # on random full-range int8 weights the kernels and the twins agree
    # product by product but not end to end: their int8 activation codes
    # agree through the early layers, then jump apart in the last ones
    # (PERF.md). That model is held product by product; Q4_K weights
    # requantized to W8 are held end to end
    cfg, model = make_device_params("llama-8b", "w8", seed=0, device=dev)
    w8, w8_counts = phase_full_width(dev, cfg, model, "w8_full_width",
                                     hold_end_to_end=False)
    emit(w8)
    del cfg, model
    torch.cuda.empty_cache()
    cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
    w8_requantize(model)
    emit(phase_full_width(dev, cfg, model, "w8_requantized")[0])
    del cfg, model
    torch.cuda.empty_cache()
    nat = phase_native(dev)
    emit(nat)
    # launches from the run of each kernel's own path
    # the W8 grouped mode's row: mixtral-lite W8's prefill gate
    w8g = next(r for r in w8_grouped_rows if r["quant"] == "w8"
               and r["block_m"] == 128 and r["proj"] == "gate")
    kernels.append(dict(
        name="qmatmul_w8_grouped", route="cuda",
        source="powerserve_tpu_torch/csrc/qmatmul_w8.cu",
        replaces="powerserve_tpu/ops/qmatmul.py:236", launches=0,
        **{key: w8g[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}))
    own = {"flash_prefill": serve_counts, "flash_decode_paged": serve_counts,
           "qmatmul_grouped": moe_counts, "qmatmul_w8": w8_counts,
           "qmatmul_w8_grouped": w8_moe_counts,
           # the fused layer chain: the 4-layer self-draft's generate; the
           # factored head's V: its generate; the state mode: the server
           **{name: spec_counts["self_draft_4"]
              for name in ("fused_x", "fused_norm", "fused_glu")},
           "fused_x_argmax": spec_counts["self_draft_4_head_rank_512"],
           "flash_decode_paged_state": spec_counts["serve"],
           # the device tree's generate; the scheduler's paged tree tick
           "flash_decode_tree": tree_counts["device_tree_self_draft_4"],
           "flash_decode_paged_tree": tree_serve_counts,
           # the EAGLE chain's generate: the fc input of every draft and
           # re-prefill
           "fused_concat2": eagle_counts["chain"],
           # the sampled plain ticks of 8 seeded requests at 0.8
           "sample": sampled_counts["sampled"],
           # rank 0's: sp_full_width's prefill chunks and decode
           "flash_decode_state": sp_counts, "flash_prefill_state": sp_counts,
           # rank 0's: the self-draft's tree over the slices
           "flash_decode_state_tree": sp_tree_counts}
    for k in kernels:
        k["launches"] = own.get(k["name"], counts)[k["name"]]
    # each decode number replayed, and its eager twin's from this run
    emit({"phase": "summary", "card": card,
          "full_width_decode_tok_s": full["decode_tok_s"],
          "full_width_decode_replayed_tok_s": full["decode_replayed_tok_s"],
          "full_width_decode_eager_tok_s": full["decode_eager_tok_s"],
          "full_width_generate_decode_tok_s": full["generate_decode_tok_s"],
          "full_width_generate_again_decode_tok_s":
              full["generate_again_decode_tok_s"],
          "full_width_generate_eager_decode_tok_s":
              full["generate_eager_decode_tok_s"],
          "w8_full_width_decode_tok_s": w8["decode_tok_s"],
          "w8_full_width_decode_eager_tok_s": w8["decode_eager_tok_s"],
          "mixtral_lite_generate_decode_tok_s":
              moe["mixtral-lite"]["generate_decode_tok_s"],
          "mixtral_lite_generate_eager_decode_tok_s":
              moe["mixtral-lite"]["generate_eager_decode_tok_s"],
          "mixtral_lite_decode_tok_s": moe["mixtral-lite"]["decode_tok_s"],
          "mixtral_lite_decode_eager_tok_s":
              moe["mixtral-lite"]["decode_eager_tok_s"],
          "serve_full_width_generated_tok_s": serve["generated_tok_s"],
          "serve_full_width_eager_generated_tok_s":
              serve["eager_twin"]["generated_tok_s"],
          "sampled_serve_generated_tok_s":
              sampled["sampled_again"]["generated_tok_s"],
          "sampled_serve_greedy_generated_tok_s":
              sampled["greedy"]["generated_tok_s"],
          "sampled_serve_self4_generated_tok_s":
              sampled["self4_sampled"]["generated_tok_s"],
          "sampled_serve_tick_gap_ms_p50":
              sampled["sampled_again"]["tick_gap_ms_p50"],
          "sampled_serve_tick_replay_ms_p50":
              sampled["sampled_again"]["tick_replay_ms_p50"],
          "serve_moe_full_width_generated_tok_s":
              serve_moe["generated_tok_s"],
          "serve_moe_full_width_eager_generated_tok_s":
              serve_moe["eager_twin"]["generated_tok_s"],
          "spec_full_width_plain_decode_tok_s": spec["plain_decode_tok_s"],
          "spec_full_width_self_draft_4_tok_s":
              spec["self_draft_4"]["decode_tok_s"],
          "spec_full_width_self_draft_4_again_tok_s":
              spec["self_draft_4"]["decode_again_tok_s"],
          "spec_full_width_self_draft_4_eager_tok_s":
              spec["self_draft_4"]["eager_decode_tok_s"],
          "spec_full_width_serve_generated_tok_s":
              spec["serve"]["generated_tok_s"],
          "spec_full_width_serve_eager_generated_tok_s":
              spec["serve"]["eager_twin"]["generated_tok_s"],
          "spec_tick_ms": spec["tick_breakdown"]["tick_ms"],
          "spec_replayed_tick_ms":
              spec["tick_breakdown"]["replayed_tick_ms"],
          "tree_self_draft_4_tok_s":
              tree["device_tree_self_draft_4"]["decode_tok_s"],
          "tree_self_draft_4_again_tok_s":
              tree["device_tree_self_draft_4"]["decode_again_tok_s"],
          "tree_self_draft_4_eager_tok_s":
              tree["device_tree_self_draft_4"]["eager_decode_tok_s"],
          "tree_self_draft_4_tokens_per_step":
              tree["device_tree_self_draft_4"]["tokens_per_step"],
          "tree_serve_generated_tok_s": tree_serve["generated_tok_s"],
          "tree_serve_eager_generated_tok_s":
              tree_serve["eager_twin"]["generated_tok_s"],
          "tree_serve_ttft_p50_s": tree_serve["ttft_p50_s"],
          "tree_serve_ttft_p90_s": tree_serve["ttft_p90_s"],
          "eagle_chain_tok_s": eagle["chain"]["decode_tok_s"],
          "eagle_chain_again_tok_s": eagle["chain"]["decode_again_tok_s"],
          "eagle_chain_eager_tok_s": eagle["chain"]["eager_decode_tok_s"],
          "eagle_chain_tokens_per_step": eagle["chain"]["tokens_per_step"],
          "eagle_tree_again_tok_s": eagle["tree"]["decode_again_tok_s"],
          "eagle_replica_again_tok_s":
              eagle["replica"]["decode_again_tok_s"],
          "eagle_replica_tokens_per_step":
              eagle["replica"]["tokens_per_step"],
          "eagle_serve_generated_tok_s": eagle_serve["generated_tok_s"],
          "eagle_serve_eager_generated_tok_s":
              eagle_serve["eager_twin"]["generated_tok_s"],
          "eagle_serve_ttft_p50_s": eagle_serve["ttft_p50_s"],
          "eagle_serve_ttft_p90_s": eagle_serve["ttft_p90_s"],
          "vlm_vision_ms_per_tile": vlm["vision_ms_per_tile"],
          "vlm_mm_prefill_tok_s": vlm["mm_prefill_tok_s"],
          "vlm_decode_tok_s": vlm["generate_decode_tok_s_again"],
          "serve_vlm_generated_tok_s": serve_vlm["generated_tok_s"],
          "serve_vlm_ttft_p50_s": serve_vlm["ttft_p50_s"],
          "serve_vlm_ttft_p90_s": serve_vlm["ttft_p90_s"],
          "session_hit_ttft_p50_s": session["hit"]["ttft_p50_s"],
          "session_cleared_ttft_p50_s": session["cleared"]["ttft_p50_s"],
          "session_restored_ttft_p50_s": session["restored"]["ttft_p50_s"],
          "session_load_s": session["load_s"],
          "session_save_s": session["save_s"],
          "serve_beside_session_loads_generated_tok_s":
              session["serve_traffic"]["beside_loads"]["generated_tok_s"],
          "serve_alone_generated_tok_s":
              session["serve_traffic"]["alone"]["generated_tok_s"],
          "evicted_freed_share": [e["freed_share"]
                                  for e in evict["evictions"]],
          "tp_full_width_ranks": tp_full["ranks"],
          "tp_full_width_decode_tok_s": tp_full["decode_tok_s"],
          "pp_full_width_prefill_tok_s": pp_full["prefill_tok_s"],
          "pp_full_width_decode_tok_s": pp_full["decode_tok_s"],
          "pp_hop_ms": pp_full["hop_ms"],
          "sp_full_width_prefill_tok_s": sp_full["prefill_tok_s"],
          "sp_full_width_decode_tok_s": sp_full["decode_tok_s"],
          "serve_pp_generated_tok_s": serve_pp_sp["pp"]["generated_tok_s"],
          "serve_sp_generated_tok_s": serve_pp_sp["sp"]["generated_tok_s"],
          "jpeg_decode_ms": vlm["jpeg"]["decode_ms"],
          "vlm_hf_dir_tokens_equal": vlm_hf["tokens_equal"],
          "serve_tp_vlm_near_ties": serve_tp_vlm["near_ties"],
          "tp_moe_tp2_decode_tok_s": tp_moe["tp2"]["decode_tok_s"],
          "tp_moe_ep2_decode_tok_s": tp_moe["ep2"]["decode_tok_s"],
          "tp_eagle_chain_tokens_per_step":
              tp_eagle["chain"]["tokens_per_step"],
          "tp_eagle_tree_tokens_per_step":
              tp_eagle["tree"]["tokens_per_step"],
          "tp_eagle_replica_accept_rate": tp_eagle["replica"]["accept_rate"],
          "w8_mixtral_lite_generate_decode_tok_s":
              w8_moe["generate_decode_tok_s"],
          "w8_mixtral_lite_generate_again_decode_tok_s":
              w8_moe["generate_again_decode_tok_s"],
          "w8_mixtral_lite_prefill_tok_s": w8_moe["prefill_tok_s"],
          "trace_decode_tok_s_traced": trace["decode_tok_s_traced"],
          "trace_decode_tok_s_untraced": trace["decode_tok_s_untraced"],
          "paged_tick_dtoh_copies": trace["paged_tick"][
              "dtoh_copies_per_tick"],
          "tools_perplexity_batch_32_tok_s": tools["batch_32"]["tok_s"],
          "tools_perplexity_batch_512_tok_s": tools["batch_512"]["tok_s"],
          "tools_cli_seconds": tools_cli["phase_seconds"],
          "native_load_s": nat["load_s_native"],
          "numpy_load_s": nat["load_s_numpy"],
          "native_tokenize_ms": nat["tokenize_ms_native"],
          "python_tokenize_ms": nat["tokenize_ms_python"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
