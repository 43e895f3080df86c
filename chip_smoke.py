#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py            # all phases, as a user would run them

Phases (every failure raises and ends the run with a non-zero code):
  1. device: name and power limit, build the CUDA kernels (timed);
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the serving path's shapes (bf16 and f32, padding, ragged lengths,
     a window, and flash at whisper-base's two non-causal forms at head
     dim 64, each timed with its own bound; for ssd_scan an initial
     state, a padded tail, a single chunk and two rows of which one is
     padded, and the device kernels a call issues; checked and timed
     also at a rank's heads under tensor parallelism, mamba2-370m's 32
     over 1 x 2: H 16, its launches those of 3t's mamba2 run), with its
     device time
     a launch on cold inputs (``ms``) and a
     single call's time (``call_ms``, host path included), its plain
     version's time, a PyTorch call that computes the same function
     where one exists (a yardstick only, timed both ways) and its bound;
     flash is timed at the dense prefill and at the 512-token chunk over
     a gathered prefix that most of its serving launches take; the decode
     pair also on K/V stored in float8_e4m3fn (an fp8 cache or pool, read
     as it is) under bf16 and f32 queries, a row without keys giving 0,
     timed with a bound of one byte a K/V element and, as its yardstick,
     the cache widened to bf16 plus SDPA; flash's gradient kernel
     (flash_attention_bwd), fed the forward's output and log-sum-exp,
     against the autograd gradient of the plain version at training
     shapes (smollm's 9/3 heads of 64 at b 4, s = S = 2048 causal;
     mistral's 32/8 of 128 at 2048; whisper's non-causal 1500 x 1500 and
     its decoder's cross-attention, 4 x 448 queries over 1500 frames; a
     window of 256; padded rows), bf16 and f32, two calls bitwise equal,
     timed with the backward of SDPA as its yardstick; each flash
     correctness case also asks the forward for its log-sum-exp, held
     against the plain version's; the SSD scan's gradient kernel
     (ssd_scan_bwd), fed the forward kernel's states, against the plain
     version of its arithmetic at mamba2-370m's training shape (B 4 x
     2048, H 32 and a rank's 16) and two small cases (an initial state, a
     final-state gradient, a ragged chunk, P 96, N 16), bf16 and (against
     the plain version run in f64) f32, two calls bitwise equal, timed; at glm4-9b's shapes (32 q heads over 2
     kv heads of 128, a group of 16): flash at its 2560 prefill and a
     512-token chunk, and the decode pair in bf16, f32 and on fp8 K/V, a
     4096-slot window case, a row without keys, and MQA (32/1, a group of
     32 run in two parts of 16), each timed with SDPA over K/V repeated
     to the 32 heads as its yardstick;
  3. model parity: llava-next-mistral-7b at full width and 2 layers in
     f32, a 2880-token image prefill plus 4 teacher-forced decode steps on
     the CPU (plain versions) and on the GPU (kernels), dense and paged,
     with f32 caches and with fp8 (float8_e4m3fn) K/V: the cast at its
     edges on the GPU equals the CPU's bitwise, the GPU prefill's fp8
     bytes equal the reference's cast of its own f32 K/V, and differ from
     the CPU prefill's only as neighbouring values (+0 and -0 being one)
     where the f32 K/V differ; the
     GPU's decode steps then read the CPU prefill's fp8 bytes;
  3b. model parity: mamba2-370m at full width and 2 layers in f32, a
     1000-token prompt padded to 2048 plus 4 teacher-forced decode steps,
     CPU against GPU;
  3m. model parity: mixtral-8x7b at full width and 2 layers in f32 at
     capacity factor 1.25, a 4352-token prompt (past the 4096 window)
     padded to 4608 plus 4 teacher-forced decode steps, dense and paged,
     CPU against GPU layer by layer (each GPU layer fed the CPU's input):
     the MoE routing (top-k experts, kept selections) agrees except at
     near-ties of the router's probabilities, counted and printed, and
     outputs and logits agree wherever routing does;
  3g. model parity: glm4-9b (group 16), deepseek-7b (MHA) and
     openpangu-7b-vl (group 7; a 1196-token image through its 1280 ->
     3584 projector) at full width and 2 layers in f32, a prompt plus 4
     teacher-forced decode steps, dense and paged, CPU against GPU;
  3w. model parity: whisper-base at full width and depth in f32, a
     40-token prompt padded to 448 with 1500 stub audio frames, then 8
     greedy decode steps, on the CPU (plain versions) and on the GPU
     (kernels): the encoder output, each layer's cross-KV, each layer's
     output in the prefill and every step, the logits and the tokens;
  3c. CUDA graphs: at full width and 2 layers in bf16 (whisper-base at
     its full depth), every call of a captured step (llava dense decode
     and dense prefill with an image and without, llava paged decode,
     each also over fp8 K/V, mamba2 decode and 2048 prefill, mixtral
     dense decode and 6144 prefill and paged decode, one request
     decoding past the window, whisper dense decode and dense prefill
     with the encoder inside, whisper paged decode) is
     also run eagerly on a copy of its caches and held bitwise against
     the engine's call, a capture's warm-up or a replay; 5 requests
     through 4 slots, so the steps cross page boundaries and a released
     slot takes a new request (the paged engine also swaps one out and
     in); the fp8 cases' launches are counted;
  3s. the dry-run's case builders (``launch/specs.build_case``) on real
     bf16 tensors under the 1x1 local mesh's rules, each output bitwise
     equal to the entry point called without rules: glm4-9b at full
     width, 2 layers (prefill 2 x 2048, then decode over its caches at
     the group of 16), smollm-135m at full size (the train case, 4 x
     2048), mixtral-8x7b at full width, 2 layers (prefill 1 x 4608 under
     expert_parallel rules) and mamba2-370m (prefill 1 x 2048); seconds
     and launches of each case;
  3d. the dry-run on the meta device (``launch/dryrun.run_case``), one
     case of each family on the 16x16 mesh: per-device argument GiB, the
     analytic compute and memory terms at H100 SXM constants, the
     collective term (glm4-9b's decode: rank 0's block counted on meta;
     null with its reason elsewhere), the bottleneck, seconds a case;
  3e. the expert-parallel branch of ``moe_block`` across ranks
     (``launch/ranks.py``): mixtral-8x7b at full width, 8 of 32 layers,
     bf16, on a process mesh of 1 x 2 (each rank 4 of the 8 experts,
     drawn layer by layer; NCCL with one card a rank where the cards
     suffice, else both ranks on one card over gloo, the line says
     which): the case builders' prefill 1 x 4608 and a decode step over
     its caches, held on every rank to the single-process run of the
     same parameters (logits and caches within the bf16 tolerance,
     greedy tokens equal up to a reported bf16 tie, flash and decode
     launched, all-gather bytes equal to layers x B x E x C x d x 2),
     and a train step at 1 x 2 on 1 layer (loss, per-leaf sums of
     squares of the new blocks); where 4 cards exist, all 32 layers at
     ep = 4 over NCCL, the ranks bitwise equal to each other;
  3t. tensor parallelism across ranks (the baseline rules, ``tp_rules()``:
     each rank its block of every leaf and cache, the collectives of the
     reference's program at the same shard points): the case builders'
     prefill 2 x 2048 and a decode step over its caches, full width,
     bf16; on one card at 1 x 2, both ranks over gloo: glm4-9b and
     mamba2-370m at full size (the SSM block on each rank's heads: its
     fused activation, conv weights and tail gathered, out_norm's sums
     of squares and w_out summed over the ranks), mixtral-8x7b at 8 of
     32 layers (MoE-TP: each expert's 'ff' cut, the expert buffers
     summed before the combine) and jamba-v0.1-52b at one 8-layer period
     (attention, SSM, MLP and MoE); where 4 cards exist, over NCCL with
     a card a rank, glm4-9b at 1 x 2 and 1 x 4 (its kv columns
     gathered, the decode cache cut over its sequence and combined
     across ranks), mamba2-370m at 1 x 2, llava-next-mistral-7b at
     1 x 4 and 2 x 2 (with image features), jamba's period at 1 x 4, and
     mixtral-8x7b and jamba-v0.1-52b at full depth at 1 x 4 (about 23
     and 26 GB of bf16 weights a rank, which no one process holds). Held
     against one process in bf16 and in f32 (but for the two full-depth
     runs): each rank's logits block, and apart from it its cache
     blocks, no farther from the f32 run than one process's bf16 blocks
     are (TP_MAX_RATIO on the largest difference, TP_MEAN_RATIO on the
     mean; the counts outside the bf16 rule printed), greedy tokens
     equal up to a reported bf16 tie; with MoE layers, only the batch
     rows whose every token the rank routed as one process did (the
     tokens routed elsewhere counted and printed), and the same ranks
     run in f32 within TP_F32_SCALE of each tensor's scale of the f32
     process, every row; the full-depth runs: the blocks put together
     finite, those the ranks share bitwise equal, each rank's greedy
     tokens equal; every run: a
     flash a prefill and a decode (or, over a sequence-cut cache, a
     flash) a decode step for each attention layer, an ssd_scan a
     prefill for each SSM layer, and the collective bytes of their
     closed form; warm seconds beside one process's; the decode step of
     glm4 and of the full-depth runs traced on rank 0 (one more step
     under torch.profiler: device ms, busy share, top kernels);
  4. serve, dense: EPDCluster at full width and depth in bf16, 4 requests
     (two sharing one image) through submit + run_until_done;
  5. serve, paged: the same requests through run_continuous on a paged
     cluster with prefix cache and chunked prefill;
  5f. serve, paged fp8: phase 5 with the cluster's engines rebuilt to
     store K/V in float8_e4m3fn (``launch/serve.py --kv-fp8``): flash
     prefills over the widened pool, paged decode reads the fp8 pool;
  4m. serve mixtral-8x7b, dense: EPDCluster at full width and 8 of 32
     layers (93.4 GB of bf16 weights do not fit the card; 8 layers are
     23.7 GB) in bf16, max_len 6144, 4 text requests (A 4608 tokens, past
     the window; B A's first 2048 and 96 of its own; 64; 1024) through
     submit + run_until_done: windowed flash, windowed dense decode;
  5m. the same requests on a paged cluster with prefix cache and chunked
     prefill of 512 through run_continuous (one live prefill, so that B
     hits A's pages in the prefix cache): windowed paged decode;
  4g. serve glm4-9b, dense: EPDCluster at full size and depth (40 layers,
     9.40 B parameters) in bf16, max_len 2560, 4 text requests (A 2048
     tokens; B A's first 1536 and 64 of its own; 64; 300), 16 new
     tokens, through submit + run_until_done: replayed prefill and decode
     graphs, the decode kernel at its group of 16; then the analytic
     model (launch/analytic.py) read against device time: the dense
     prefill's model-FLOPs share of 989 TFLOP/s and a decode step's
     analytic bytes against 3.35 TB/s;
  5g. the same requests on a paged cluster with prefix cache and chunked
     prefill of 512 through run_continuous (one live prefill, so that B
     hits A's pages): paged decode at the group of 16; greedy tokens
     equal 4g's;
  4w. serve whisper-base, dense: EPDCluster at full width and depth in
     bf16, max_len 448 (its decoder context), 4
     audio requests (two share one payload) of 4-64 prompt tokens, 32 new
     tokens each, through submit + run_until_done: flash over 1500
     encoder frames and as cross-attention (one query a slot inside the
     replayed decode step), dense decode;
  5w. the same requests on a paged cluster (page 16) through
     run_continuous, as monolithic prefill jobs: paged decode; greedy
     tokens equal 4w's;
  4b. serve mamba2-370m, dense: EPDCluster at full width and depth (48
     layers) in bf16, max_len 2048, 4 text requests of 64-1900 tokens,
     through submit + run_until_done, then run_continuous;
  7. training parity: smollm-135m and mamba2-370m at full width and 2
     layers in f32, one train step (batch 2 x 512) on the CPU (plain
     versions) and on the GPU (flash and its gradient kernel; ssd_scan
     and ssd_scan_bwd): the loss, every gradient leaf (max error beside
     max |g|) and the updated params; remat=True equals remat=False on
     the card bitwise;
  7t. training smollm-135m (30 layers) and mamba2-370m (48 layers) at
     full width and depth in bf16, batch 4 x 2048, loss_chunk 512, remat,
     20 steps of synthetic_batches: the loss curve falls; ms a step,
     tokens/s, peak memory; the forward kernel's launches (twice a layer
     a step, remat's recompute) and its gradient's (once); one more step
     traced with torch.profiler: the top device kernels, the device time
     by launching op and by part of the step (cuBLAS, the forward, each
     gradient device kernel, PyTorch's own kernels), each gradient
     kernel's share of the step; then, for smollm, a checkpoint saved,
     restored and one more step, bitwise equal to the step without the
     round trip;
  7r. the train step across ranks (``launch/ranks.py``; the case
     builders' train case under the baseline rules, each rank its block
     of every leaf and AdamW moment and its share of each microbatch):
     smollm-135m at full size, bf16, 7t's batch of 4 x 2048, two steps
     at 2 x 1 (pure data parallel: the gradients all-reduced in one flat
     f32 buffer over the two microbatches) and at 1 x 2 (q and K/V
     columns gathered, 'ff' and 'vocab' cut), mixtral-8x7b at full
     width, 1 layer, 2 x 1024 under MoE-TP at 1 x 2, and mamba2-370m at
     full width, 16 of 48 layers, at 1 x 2 (the SSM block's transposes,
     ssd_scan_bwd on each rank's heads), both ranks on one card over
     gloo; where 4 cards exist, over NCCL with a card a rank,
     smollm-135m at 2 x 2, glm4-9b (2 layers) at 1 x 4, mixtral-8x7b (1
     layer) at 2 x 2 under the expert-parallel rules and under MoE-TP,
     and mamba2-370m at full size at 2 x 2. Held on every
     rank against one process of the same plan in bf16 and in f32: the
     loss of each step, bitwise equal across ranks; the digests of the
     rank's blocks of the new parameters, mu and nu no farther from the
     f32 run's than one bf16 process's; flash's and ssd_scan's forward
     and gradient launches; the collective bytes of their closed form
     (``_train_bytes``); seconds a step against one process's, and one
     more step after the last traced on rank 0;
  6. numbers: wall-clock TTFT, TPOT and tokens/s of the serving phases,
     and phase 7t's step time, tokens/s and peak memory.
Every serving cluster models its transfer charges on the H100 cost
profile (``costmodel.H100``). The kernel launch counters are set to 0
just before each serving run and read just after it (a CUDA-graph
replay adds the launches its capture recorded); each run must have
launched every kernel of its path and replayed its decode graph, and
prints its captures and replays. The last lines are a JSON object per
kernel, the card's name and power limit, and {"ok": true, "device":
{...}}.

``--phases`` runs a subset (``--phases 1,2``: build and kernel checks;
``--phases 1,7,7t``: training; ``--phases 1,7r``: training across ranks). Serving launches no gradient kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),   # 8-bit mantissa out
       "float32": dict(atol=1e-4, rtol=1e-4)}    # summation order only
PARITY_TOL = dict(atol=1e-3, rtol=1e-3)          # f32 logits, CPU vs GPU
# flash's log-sum-exp: f32 on both sides from the same rounded inputs
LSE_TOL = TOL["float32"]
KERNEL_INFO = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:69"),
    "paged_decode_attention": dict(
        source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention/kernel.py:81"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:78"),
    # no TPU kernel: the reference trains through attention_ref, whose
    # gradient JAX derives; this is the card's counterpart of that gradient
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/ref.py:43"),
    # the same for the SSD scan: the reference trains through ssd_chunked
    "ssd_scan_bwd": dict(
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/models/ssm.py:57"),
}
MAX_LEN = 3072
IMAGE_TOKENS = 2880
# glm4-9b: 32 q heads over 2 kv heads of 128, a group of 16
GLM_HEADS = (32, 2)
GLM_MAX_LEN = 2560       # its longest prompt, 2048, and 16 new tokens
# phases 4g, 5g: A 2048 tokens, B A's first 1536 and 64 of its own (a
# prefix-cache hit on the paged cluster), C and D short
GLM_PROMPTS = (2048, 1536 + 64, 64, 300)
# phase 3g: full width, 2 layers, f32, CPU against GPU
CONFIG_PARITY = ("glm4-9b", "deepseek-7b", "openpangu-7b-vl")
# phase 5g: the dense and the paged run may part at a bf16 near-tie
# (their prefills differ in shape: one 2560-row prefill against 512-token
# chunks over a cached prefix, so bf16 rounds them differently); where
# they part, the two tokens must be the top two of a third forward over
# the common prefix, within this many bf16 ulps of the top logit
TIE_ULPS = 4
SSM_MAX_LEN = 2048      # mamba2's training context, a multiple of its chunk
SSM_PROMPTS = (64, 256, 1000, 1900)
MOE_MAX_LEN = 6144       # past mixtral's 4096 window, a multiple of 512
MOE_LAYERS = 8           # of 32: 93.4 GB of bf16 weights do not fit 80 GB
MOE_PROMPT, MOE_PARITY_LEN = 4352, 4608   # phase 3m: prompt, padded length
MOE_MARGIN = 1e-5        # 3m: a near-tie of router probabilities may flip
# phases 4m, 5m: A past the window, B A's first 2048 tokens and 96 of its
# own (a prefix-cache hit on the paged cluster), C and D short
MOE_PROMPTS = (4608, 2048 + 96, 64, 1024)
WHISPER_MAX_LEN = 448    # whisper's decoder context, a multiple of 16
# phases 7, 7t: smollm-135m training
TRAIN_BATCH, TRAIN_SEQ = 4, 2048     # 7t: 8192 tokens a step
TRAIN_CHUNK = 512                    # 7t: loss_chunk of the lm head
TRAIN_STEPS = 20
PARITY_TRAIN = (2, 512)              # 7: batch, seq of the CPU-vs-GPU step
# phase 3d: one case of each family on the 16x16 mesh, on the meta device:
# dense, MoE (expert_parallel rules, mesh None), SSM, encoder-decoder
DRYRUN_CASES = (("glm4-9b", "decode_32k", ()),
                ("mixtral-8x7b", "prefill_32k", (("expert_parallel", True),)),
                ("mamba2-370m", "long_500k", ()),
                ("whisper-base", "train_4k", ()))
# phase 3e: the expert-parallel branch across ranks
EP_MESH = (1, 2)         # data x model: each rank 4 of mixtral's 8 experts
EP_TRAIN = (1, 512)      # its train step: batch x length
# at full width one layer's train step needs about 41 GB in one process
# and two ranks on one card about 23 GB each; two layers would need 82 GB
EP_TRAIN_LAYERS = 1
EP_DIGEST_RTOL = 1e-2    # per-leaf sums of squares after the train step
RANKS_TIMEOUT = 600      # seconds a group of ranks may take
# phase 3t: tensor parallelism across ranks under the baseline rules, 3s's
# prefill (batch, padded length, true lengths), then one decode step
TP_PREFILL = (2, 2048, (2048, 1900))
# (arch, mesh, layers (None: all), held to one process): glm4-9b and
# mamba2-370m at full size, mixtral-8x7b at 3e's 8 of 32 layers (MoE-TP),
# jamba-v0.1-52b at one 8-layer period (1 attention, 7 SSM, 4 MoE layers,
# about 26.6 GB of bf16 weights; its f32 yardstick alone about 53 GB)
TP_ONE_CARD = (("glm4-9b", (1, 2), None, True),
               ("mamba2-370m", (1, 2), None, True),
               ("mixtral-8x7b", (1, 2), MOE_LAYERS, True),
               ("jamba-v0.1-52b", (1, 2), 8, True))
# a rank's distance from the f32 run against one process's, over the
# logits and over the caches: the mean, and the largest difference (an
# extreme over up to 1e8 values: up to 1.26 measured on an H100 80GB HBM3,
# so the wider margin)
TP_MAX_RATIO, TP_MEAN_RATIO = 1.5, 1.10
# the ranks in f32 against the f32 process: the largest difference of a
# tensor over its largest magnitude (the order of the sums is the one
# difference; bf16's own rounding is 4e-3 of a value)
TP_F32_SCALE = 1e-3
# at full depth mixtral-8x7b (about 23 GB of bf16 weights a rank at 1 x 4)
# and jamba-v0.1-52b (about 26 GB) fit no one process: their ranks are
# held to each other and to the closed form only
TP_FOUR_CARDS = (("glm4-9b", (1, 2), None, True),
                 ("glm4-9b", (1, 4), None, True),
                 ("mamba2-370m", (1, 2), None, True),
                 ("llava-next-mistral-7b", (1, 4), None, True),
                 ("llava-next-mistral-7b", (2, 2), None, True),
                 ("jamba-v0.1-52b", (1, 4), 8, True),
                 ("mixtral-8x7b", (1, 4), None, False),
                 ("jamba-v0.1-52b", (1, 4), None, False))
# the ranks' decode step traced (rank 0's printed): the kv heads cut and
# the cache cut over its sequence; the full-depth MoE and hybrid runs
TP_TRACED = (("glm4-9b", (1, 2)), ("glm4-9b", (1, 4)),
             ("mixtral-8x7b", (1, 4)), ("jamba-v0.1-52b", (1, 4)))
# phase 7r: the train step across ranks, TRAIN_RANK_STEPS steps a run:
# (arch, mesh, layers (None: all), batch x length, expert-parallel rules)
TRAIN_RANK_STEPS = 2
TRAIN_ONE_CARD = (("smollm-135m", (2, 1), None, (TRAIN_BATCH, TRAIN_SEQ),
                   False),
                  ("smollm-135m", (1, 2), None, (TRAIN_BATCH, TRAIN_SEQ),
                   False),
                  ("mixtral-8x7b", (1, 2), 1, (2, 1024), False),
                  # 16 of 48 layers: at full depth its gloo ranks took
                  # 137 s, past the script's 900 s
                  ("mamba2-370m", (1, 2), 16, (TRAIN_BATCH, TRAIN_SEQ),
                   False))
# one process, which the ranks are held to, keeps bf16 weights, their f32
# gradient sum and AdamW's two f32 moments, old and new: about 92 GB for
# glm4-9b at 8 layers and more for mixtral at 4, so 2 and 1 layers.
# jamba-v0.1-52b's 8-layer period does not train at 1 x 4 on 80 GB cards:
# a rank's 3.3 B parameters take about 73 GB in bf16 weights, gradients
# and f32 moments, old and new, and AdamW's update ran out of memory at
# 74.7 GiB allocated (an H100 80GB HBM3)
TRAIN_FOUR_CARDS = (("smollm-135m", (2, 2), None, (TRAIN_BATCH, TRAIN_SEQ),
                     False),
                    ("glm4-9b", (1, 4), 2, (2, 2048), False),
                    ("mixtral-8x7b", (2, 2), 1, (2, 1024), True),
                    ("mixtral-8x7b", (2, 2), 1, (2, 1024), False),
                    ("mamba2-370m", (2, 2), None, (TRAIN_BATCH, TRAIN_SEQ),
                     False))
L2_BYTES = 50 * 2 ** 20  # H100 L2
DEVICE_LAUNCHES = 60     # launches a device timing
# the SSD scan's final state is f32 on both sides, from the same rounded
# inputs: only the summation order differs, whatever the input dtype
SSD_STATE_TOL = TOL["float32"]


def log(msg: str) -> None:
    print(msg, flush=True)


def release(torch) -> None:
    """Free what a finished phase or timing held: engines keep their CUDA
    graphs in reference cycles, so collect them, then return the cached
    memory. A timed run then starts from the same state whatever ran
    before it, instead of destroying earlier graphs inside its own time."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(torch, fn, n: int = 25, warmup: int = 3) -> float:
    """Median of ``n`` CUDA-event timings of ``fn`` after ``warmup`` calls:
    one call between each pair of events, so a call shorter than its
    host path (checks, allocations, the launch) reads that path too. Kept
    for the plain versions and as ``call_ms`` / ``library_call_ms``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def n_sets(nbytes: int) -> int:
    """Input sets to rotate over so that, between two launches on one set,
    the other sets move at least twice the L2: each launch then finds its
    inputs in device memory, as a serving layer finds its cache."""
    return 1 + -(-2 * L2_BYTES // nbytes)


def device_ms(torch, fn, sets, n: int = DEVICE_LAUNCHES) -> float:
    """Device time per launch of ``fn(*set)``: ``n`` launches rotating over
    ``sets``, queued back to back between one pair of CUDA events, after
    one warm-up launch a set. A spin kernel (``torch.cuda._sleep``) queued
    before the first event holds the device until the host has queued all
    ``n``, so the reading holds no host time; if the spin ended first, a
    longer one is tried, then the timing fails."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*sets[i % len(sets)])
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    for spin_ms in (3 * host_ms + 2, 30 * host_ms + 20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * spin_ms))
        a.record()
        for i in range(n):
            fn(*sets[i % len(sets)])
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / n
    raise RuntimeError("device_ms: the spin ended before the host had "
                       "queued the launches")


def device_kernels(torch, fn) -> int:
    """Device kernels that one call of ``fn`` (after a warm-up call)
    issues: the kernel nodes of a CUDA graph that captures the call
    (``graphs.node_census``). torch.profiler's records of one call, read
    here before, once held 5 of ssd_scan_bwd's 7 kernels late in the
    whole script (an H100 80GB HBM3), and 7 in every call alone."""
    from repro_torch.serving.graphs import node_census
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = node_census(graph).kernel_nodes
    del graph
    release(torch)
    return n


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sdpa(q, k, v, mask):
    """One PyTorch call computing the same attention: q (b, h, s, d),
    k/v (b, hk, S, d), boolean mask broadcastable to (b, h, s, S)."""
    from torch.nn import functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:                      # torch without enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            attn_mask=mask)


def timing(torch, first, make, kernel, plain, library, nbytes, flops,
           shape, plain_n=25, peak=PEAK_BF16):
    """Times of one kernel at one shape, and its bound. ``make()`` draws a
    fresh input set: the kernel's arguments and the library call's (or
    None); ``first`` is one already drawn. ``ms`` and ``library_ms`` are
    device times on cold inputs (``device_ms`` over ``n_sets(nbytes)``
    sets); ``call_ms``, ``library_call_ms`` and ``plain_ms`` time single
    calls on the first set (``time_ms``). ``peak``: the FLOP/s of the
    bound (bf16 tensor cores by default)."""
    sets = [first] + [make() for _ in range(n_sets(nbytes) - 1)]
    kargs = [s[0] for s in sets]
    r = dict(ms=device_ms(torch, kernel, kargs),
             call_ms=time_ms(torch, lambda: kernel(*kargs[0])),
             plain_ms=time_ms(torch, lambda: plain(*kargs[0]), n=plain_n),
             library_ms=None, library_call_ms=None,
             bound_ms=1e3 * max(flops / peak, nbytes / HBM_BPS),
             bound_by="operations" if flops / peak > nbytes / HBM_BPS
             else "bytes", n_sets=len(sets), shape=shape)
    if library is not None:
        largs = [s[1] for s in sets]
        r.update(library_ms=device_ms(torch, library, largs),
                 library_call_ms=time_ms(torch, lambda: library(*largs[0])))
    del sets, kargs
    release(torch)
    return r


def log_timing(name, r):
    lib = ("None" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} library_call_ms={r['library_call_ms']:.4f}")
    log(f"  {name}: ms={r['ms']:.4f} (device, cold: {DEVICE_LAUNCHES} "
        f"launches over {r['n_sets']} input sets) call_ms={r['call_ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound reached, at "
        f"{r['shape']}")


def check_close(torch, name, label, dtype, out, ref, empty=()):
    """``out`` within TOL of ``ref``; rows ``empty`` (no valid key)
    must be 0 in the kernel (the plain versions give the mean of V
    there) and are left out of the comparison."""
    zero = True
    if empty:
        zero = bool((out[list(empty)] == 0).all())
        rows = [i for i in range(out.shape[0]) if i not in empty]
        out, ref = out[rows], ref[rows]
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[dtype])
    log(f"  {name} [{label}] {dtype}: max_abs_err={err:.3e} "
        f"tol={TOL[dtype]}"
        + (f", rows {list(empty)} without keys 0: {zero}" if empty
           else "") + f" {'ok' if ok and zero else 'FAIL'}")
    assert ok and zero and torch.isfinite(out.float()).all(), (
        name, label, err)
    return err


def check_lse(torch, label, dtype, with_lse, lse_ref, out, q, k, v, qp, kp,
              window, causal):
    """The forward asked for each row's log-sum-exp (as training asks):
    the lse within LSE_TOL of the plain version's, +inf on the same rows
    (no valid key), and the output the call's without it, bitwise."""
    got_out, lse = with_lse(q, k, v, qp, kp, window=window, causal=causal)
    want = lse_ref(q, k, qp, kp, window=window, causal=causal)
    inf = torch.isposinf(want)
    same_inf = bool(torch.equal(torch.isposinf(lse), inf))
    err = (lse[~inf] - want[~inf]).abs().max().item() if (~inf).any() else 0.
    ok = same_inf and torch.allclose(lse[~inf], want[~inf], **LSE_TOL)
    same = bool(torch.equal(got_out, out))
    log(f"  flash_attention lse [{label}] {dtype}: max_abs_err={err:.3e} "
        f"tol={LSE_TOL}, rows without keys +inf: {same_inf}, output as "
        f"without lse: {same} {'ok' if ok and same else 'FAIL'}")
    assert ok and same, (label, dtype, err)


def decode_inputs(torch, gen, dtype, heads, S, lengths, kv=None, hd=128):
    """The dense decode kernel's operands, drawn from ``gen`` on its
    device: q (b, nq, hd) in ``dtype``; a ring cache k, v (b, S, nkv, hd)
    in ``dtype`` or stored in ``kv`` (fp8, cast as the caches cast,
    models/layers.py to_kv) whose slots [0, length) hold positions 0..;
    q_pos = length - 1 (-1 for a row without keys); kv_pos."""
    from repro_torch.models.layers import to_kv
    dev = gen.device
    nq, nkv = heads
    b, dt = len(lengths), getattr(torch, dtype)

    def store(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x.to(dt) if kv is None else to_kv(x, kv)
    q = torch.randn((b, nq, hd), generator=gen, device=dev).to(dt)
    k, v = store((b, S, nkv, hd)), store((b, S, nkv, hd))
    t = torch.arange(S, dtype=torch.int32, device=dev)[None]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kpos = torch.where(t < ln[:, None], t, torch.full_like(t, -1))
    return q, k, v, (ln - 1).contiguous(), kpos.contiguous()


def paged_inputs(torch, gen, dtype, heads, page, max_pages, lengths,
                 kv=None, hd=128):
    """The paged decode kernel's operands, drawn from ``gen``: q (b, nq,
    hd); pools (1 + b max_pages, page, nkv, hd) as ``decode_inputs``
    stores K/V; a block table of scattered physical pages (page 0 left
    as trash), at least one a slot; lengths."""
    from repro_torch.models.layers import to_kv
    dev = gen.device
    nq, nkv = heads
    b, dt = len(lengths), getattr(torch, dtype)
    n_pages = 1 + b * max_pages

    def store(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x.to(dt) if kv is None else to_kv(x, kv)
    q = torch.randn((b, nq, hd), generator=gen, device=dev).to(dt)
    kpool = store((n_pages, page, nkv, hd))
    vpool = store((n_pages, page, nkv, hd))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(lengths):
        used = max(1, -(-n // page))
        tbl[i, :used] = perm[off:off + used].to(torch.int32)
        off += used
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kpool, vpool, tbl, ln


def check_kernels(torch, dev):
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)
    from repro_torch.kernels.paged_decode_attention.kernel import (
        paged_decode_attention)
    from repro_torch.kernels.paged_decode_attention.ref import (
        paged_decode_attention_ref)

    f8 = torch.float8_e4m3fn
    gen = torch.Generator(device=dev).manual_seed(1234)
    nq, nkv, hd = 32, 8, 128
    lens = [2960, 3000, 100, 64]          # two VLM prompts, two text ones
    results = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    compare = functools.partial(check_close, torch)
    # -- flash: engine prefill (pad to max_len), suffix chunk, window, cross
    def flash_case(dtype, s, S, n_valid, q_off=0, pfx=None, window=None,
                   causal=True, heads=(nq, nkv), dim=hd):
        b = 1
        dt = getattr(torch, dtype)
        h, hk = heads
        q = randn((b, s, h, dim), dt)
        k = randn((b, S, hk, dim), dt)
        v = randn((b, S, hk, dim), dt)
        qi = torch.arange(s, dtype=torch.int32, device=dev)
        qpos = torch.where(qi < n_valid, qi + q_off,
                           torch.full_like(qi, -1)).repeat(b, 1)
        if pfx is None:
            kpos = qpos.clone() if S == s else torch.arange(
                S, dtype=torch.int32, device=dev).repeat(b, 1)
        else:      # suffix prefill: gathered prefix row + in-batch suffix
            span = torch.arange(S - s, dtype=torch.int32, device=dev)
            kpos = torch.cat([torch.where(span < pfx, span,
                                          torch.full_like(span, -1)),
                              qpos[0]]).repeat(b, 1)
        return q, k, v, qpos.contiguous(), kpos.contiguous(), window, causal

    flash_cases = [
        ("prefill 3072, 2960 valid", "bfloat16",
         dict(s=MAX_LEN, S=MAX_LEN, n_valid=2960)),
        ("prefill 3072, 2960 valid", "float32",
         dict(s=MAX_LEN, S=MAX_LEN, n_valid=2960)),
        ("chunk 512 over 3072+512, prefix 1024", "bfloat16",
         dict(s=512, S=MAX_LEN + 512, n_valid=512, q_off=1024, pfx=1024)),
        ("prefill 1024, window 256", "bfloat16",
         dict(s=1024, S=1024, n_valid=1000, window=256)),
        ("cross 50x70", "float32",
         dict(s=50, S=70, n_valid=47, causal=False, heads=(4, 2), dim=64)),
    ]
    errs = []
    for label, dtype, kw in flash_cases:
        q, k, v, qp, kp, win, causal = flash_case(dtype, **kw)
        out = flash_attention(q, k, v, qp, kp, window=win, causal=causal)
        ref = attention_ref(q, k, v, qp, kp, window=win, causal=causal)
        err = compare("flash_attention", label, dtype, out, ref)
        if dtype == "bfloat16":
            errs.append(err)
        check_lse(torch, label, dtype, flash_attention_with_lse,
                  attention_lse_ref, out, q, k, v, qp, kp, win, causal)
    def flash_timing(label, kw):
        """Kernel, plain and SDPA times and the bound of one causal case."""
        def make():
            q, k, v, qp, kp, _, _ = flash_case("bfloat16", **kw)
            valid = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
                     & (kp[:, None, :] <= qp[:, :, None]))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            return (q, k, v, qp, kp), (qt, kt, vt, valid[:, None])
        first = make()
        (q, k, v, qp, kp), (_, _, _, valid) = first
        n_pairs = int(valid.sum().item())
        h, hk, d = q.shape[2], k.shape[2], q.shape[3]
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (
            qp.numel() + kp.numel())
        return timing(torch, first, make, flash_attention, attention_ref,
                      sdpa, nbytes, 4 * d * h * n_pairs, plain_n=20,
                      shape=f"{label}: b1 s{q.shape[1]} S{k.shape[1]} "
                            f"nq{h} nkv{hk} hd{d} bf16, {n_pairs} valid "
                            f"pairs")

    # the dense prefill, and the chunk shape that most serving launches take
    results["flash_attention"] = dict(
        max_abs_err=max(errs), **flash_timing(*flash_cases[0][::2]))
    chunk = flash_timing(*flash_cases[2][::2])
    log_timing("flash_attention chunk", chunk)
    results["flash_attention"]["chunk"] = chunk
    # glm4-9b's prefill forms (32/2 heads of 128, a group of 16): phase
    # 4g's dense prefill of its 2048-token prompt padded to GLM_MAX_LEN,
    # and phase 5g's 512-token chunk over a 1536-token cached prefix
    glm = dict(heads=GLM_HEADS)
    glm_cases = [
        ("glm4 prefill 2560, 2048 valid", "bfloat16",
         dict(s=GLM_MAX_LEN, S=GLM_MAX_LEN, n_valid=2048, **glm)),
        ("glm4 prefill 2560, 2048 valid", "float32",
         dict(s=GLM_MAX_LEN, S=GLM_MAX_LEN, n_valid=2048, **glm)),
        ("glm4 chunk 512 over 2560+512, prefix 1536", "bfloat16",
         dict(s=512, S=GLM_MAX_LEN + 512, n_valid=512, q_off=1536, pfx=1536,
              **glm))]
    errs = []
    for label, dtype, kw in glm_cases:
        q, k, v, qp, kp, win, causal = flash_case(dtype, **kw)
        out = flash_attention(q, k, v, qp, kp, window=win, causal=causal)
        ref = attention_ref(q, k, v, qp, kp, window=win, causal=causal)
        err = compare("flash_attention", label, dtype, out, ref)
        if dtype == "bfloat16":
            errs.append(err)
    results["flash_attention_glm4"] = dict(
        max_abs_err=max(errs), **flash_timing(*glm_cases[0][::2]))
    results["flash_attention_glm4"]["chunk"] = flash_timing(
        *glm_cases[2][::2])
    log_timing("flash_attention glm4 chunk",
               results["flash_attention_glm4"]["chunk"])

    # -- dense decode: 4 slots of a 3072 ring buffer, ragged lengths
    def decode_case(dtype, lengths, window=None, kv=None):
        return (*decode_inputs(torch, gen, dtype, (nq, nkv), MAX_LEN,
                               lengths, kv), window)

    errs = []
    for label, dtype, lengths, win in [
            ("b4 S3072 ragged", "bfloat16", lens, None),
            ("b4 S3072 ragged", "float32", lens, None),
            ("b4 S3072 window 512", "bfloat16", lens, 512),
            ("b4 S3072 full + 1", "bfloat16", [MAX_LEN, 1, 17, 2049], None)]:
        q, k, v, qp, kp, w = decode_case(dtype, lengths, win)
        err = compare("decode_attention", label, dtype,
                      decode_attention(q, k, v, qp, kp, window=w),
                      decode_attention_ref(q, k, v, qp, kp, window=w))
        if dtype == "bfloat16":
            errs.append(err)
    def decode_set(kv=None):
        q, k, v, qp, kp, _ = decode_case("bfloat16", lens, kv=kv)
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        return (q, k, v, qp, kp), (q[:, :, None], kt, vt,
                                   (kp >= 0)[:, None, None])
    first = decode_set()
    q, _, _, qp, kp = first[0]
    n_tok = sum(lens)
    nbytes = (2 * n_tok * nkv * hd * 2 + 2 * 2 * q.numel()
              + 4 * (kp.numel() + qp.numel()))
    results["decode_attention"] = dict(
        max_abs_err=max(errs),
        **timing(torch, first, decode_set, decode_attention,
                 decode_attention_ref, sdpa, nbytes, 4 * hd * nq * n_tok,
                 shape=f"b4 S{MAX_LEN} nq{nq} nkv{nkv} hd{hd} bf16, "
                       f"lengths {lens}"))

    # -- paged decode: page 16, 192 pages a slot, scattered pages
    page, max_pages = 16, MAX_LEN // 16

    def paged_case(dtype, lengths, window=None, kv=None):
        return (*paged_inputs(torch, gen, dtype, (nq, nkv), page, max_pages,
                              lengths, kv), window)

    errs = []
    for label, dtype, lengths, win in [
            ("b4 page16 ragged", "bfloat16", lens, None),
            ("b4 page16 ragged", "float32", lens, None),
            ("b4 page16 window 300", "bfloat16", lens, 300),
            ("b4 page boundaries", "float32", [16, 32, MAX_LEN, 1], None)]:
        args = paged_case(dtype, lengths, win)
        err = compare("paged_decode_attention", label, dtype,
                      paged_decode_attention(*args[:5], window=args[5]),
                      paged_decode_attention_ref(*args[:5], window=args[5]))
        if dtype == "bfloat16":
            errs.append(err)
    # yardstick: SDPA over the same KV laid out densely beforehand (no
    # single PyTorch call reads a paged pool; the gather is not timed)
    def paged_set(kv=None):
        q, kpool, vpool, tbl, ln, _ = paged_case("bfloat16", lens, kv=kv)
        kd, vd = (x[tbl.long()].reshape(len(lens), -1, nkv, hd)
                  .transpose(1, 2).contiguous() for x in (kpool, vpool))
        t = torch.arange(kd.shape[2], device=dev)[None]
        return (q, kpool, vpool, tbl, ln), (q[:, :, None], kd, vd,
                                            (t < ln[:, None])[:, None, None])
    first = paged_set()
    q, _, _, _, ln = first[0]
    n_pg = sum(-(-n // page) for n in lens)
    nbytes = (2 * n_tok * nkv * hd * 2 + 2 * 2 * q.numel()
              + 4 * (n_pg + ln.numel()))
    results["paged_decode_attention"] = dict(
        max_abs_err=max(errs),
        **timing(torch, first, paged_set, paged_decode_attention,
                 paged_decode_attention_ref, sdpa, nbytes,
                 4 * hd * nq * n_tok,
                 shape=f"b4 page{page} max_pages{max_pages} nq{nq} nkv{nkv} "
                       f"hd{hd} bf16, lengths {lens}"))
    for name, r in results.items():
        log_timing(name, r)

    # -- the decode pair on fp8 K/V (float8_e4m3fn, read as it is): the
    # cases above, and a row / slot without keys, which gives 0
    no_keys = [2960, 0, 100, 64]
    fp8 = {"decode_attention": [], "paged_decode_attention": []}
    for label, dtype, lengths, win in [
            ("fp8 K/V, b4 S3072 ragged", "bfloat16", lens, None),
            ("fp8 K/V, b4 S3072 ragged", "float32", lens, None),
            ("fp8 K/V, b4 S3072 window 512", "bfloat16", lens, 512),
            ("fp8 K/V, b4 S3072 full + 1", "float32", [MAX_LEN, 1, 17, 2049],
             None),
            ("fp8 K/V, b4 S3072 row 1 without keys", "bfloat16", no_keys,
             None)]:
        q, k, v, qp, kp, w = decode_case(dtype, lengths, win, kv=f8)
        err = compare("decode_attention", label, dtype,
                      decode_attention(q, k, v, qp, kp, window=w),
                      decode_attention_ref(q, k, v, qp, kp, window=w),
                      empty=[i for i, n in enumerate(lengths) if n == 0])
        fp8["decode_attention"].append((dtype, err))
    for label, dtype, lengths, win in [
            ("fp8 K/V, b4 page16 ragged", "bfloat16", lens, None),
            ("fp8 K/V, b4 page16 ragged", "float32", lens, None),
            ("fp8 K/V, b4 page16 window 300", "bfloat16", lens, 300),
            ("fp8 K/V, b4 page boundaries", "float32", [16, 32, MAX_LEN, 1],
             None),
            ("fp8 K/V, b4 slot 1 without keys", "bfloat16", no_keys, None)]:
        args = paged_case(dtype, lengths, win, kv=f8)
        err = compare("paged_decode_attention", label, dtype,
                      paged_decode_attention(*args[:5], window=args[5]),
                      paged_decode_attention_ref(*args[:5], window=args[5]),
                      empty=[i for i, n in enumerate(lengths) if n == 0])
        fp8["paged_decode_attention"].append((dtype, err))

    def widened_sdpa(q, k, v, mask):
        """The yardstick of an fp8 cache: widened to bf16, then SDPA,
        timed as one function."""
        return sdpa(q, k.to(torch.bfloat16), v.to(torch.bfloat16), mask)

    # bound: one byte a K/V element (q and out bf16, positions int32)
    b = len(lens)
    nbytes = (2 * n_tok * nkv * hd + 2 * 2 * b * nq * hd
              + 4 * b * (MAX_LEN + 1))
    dense8 = timing(torch, decode_set(f8), lambda: decode_set(f8),
                    decode_attention, decode_attention_ref, widened_sdpa,
                    nbytes, 4 * hd * nq * n_tok,
                    shape=f"b4 S{MAX_LEN} nq{nq} nkv{nkv} hd{hd} bf16 q, "
                          f"fp8 K/V, lengths {lens}")
    nbytes = 2 * n_tok * nkv * hd + 2 * 2 * b * nq * hd + 4 * (n_pg + b)
    paged8 = timing(torch, paged_set(f8), lambda: paged_set(f8),
                    paged_decode_attention, paged_decode_attention_ref,
                    widened_sdpa, nbytes, 4 * hd * nq * n_tok,
                    shape=f"b4 page{page} max_pages{max_pages} nq{nq} "
                          f"nkv{nkv} hd{hd} bf16 q, fp8 K/V, lengths {lens}")
    for name, r in (("decode_attention", dense8),
                    ("paged_decode_attention", paged8)):
        r["max_abs_err"] = max(e for d, e in fp8[name] if d == "bfloat16")
        log_timing(f"{name} fp8", r)
        results[name]["fp8"] = r
    return results


def check_decode_groups(torch, dev):
    """The decode pair at glm4-9b's group of 16 (32 q heads over 2 kv
    heads of 128) and at an MQA group of 32 (32/1, two parts of 16 along
    the grid): b 4 over 3072 slots, lengths [2960, 3000, 100, 64], page
    16, in bf16, f32 and on fp8 K/V under bf16 q, a 4096-slot case with a
    window of 1024, and a row without keys (which gives 0). Each row is
    held against the plain version (TOL of q's dtype) and timed as phase
    2's rows: cold device ms, call_ms, the plain version, the bound, and
    as the yardstick SDPA with the same mask over K/V repeated to the 32
    q heads (fp8: widened to bf16 inside the timed call). Returns
    {wrapper: {case: row}}."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.paged_decode_attention.kernel import (
        paged_decode_attention)
    from repro_torch.kernels.paged_decode_attention.ref import (
        paged_decode_attention_ref)

    f8 = torch.float8_e4m3fn
    gen = torch.Generator(device=dev).manual_seed(4321)
    hd, page = 128, 16
    lens = [2960, 3000, 100, 64]
    no_keys = [2960, 0, 100, 64]

    def visible(pos, qp, window):
        """Keys each query sees: (b, S) bool."""
        ok = (pos >= 0) & (pos <= qp[:, None])
        if window is not None:
            ok &= pos > qp[:, None] - window
        return ok

    def library_args(q, k, v, ok):
        """SDPA's operands: q (b, nq, 1, hd), K/V (b, nkv, S, hd)
        repeated to the nq heads, the mask (b, 1, 1, S)."""
        g = q.shape[1] // k.shape[2]
        kt, vt = (x.transpose(1, 2).repeat_interleave(g, 1).contiguous()
                  for x in (k, v))
        return q[:, :, None], kt, vt, ok[:, None, None]

    def dense(dtype, heads, S, lengths, window, kv):
        q, k, v, qp, kp = decode_inputs(torch, gen, dtype, heads, S,
                                        lengths, kv)
        ok = visible(kp, qp, window)
        return ((q, k, v, qp, kp), library_args(q, k, v, ok),
                int(ok.sum()), 4 * (kp.numel() + qp.numel()))

    def paged(dtype, heads, S, lengths, window, kv):
        b, nkv = len(lengths), heads[1]
        q, kpool, vpool, tbl, ln = paged_inputs(torch, gen, dtype, heads,
                                                page, S // page, lengths, kv)
        kd, vd = (x[tbl.long()].reshape(b, -1, nkv, hd)
                  for x in (kpool, vpool))
        t = torch.arange(S, dtype=torch.int32, device=dev)[None]
        ok = visible(torch.where(t < ln[:, None], t, torch.full_like(t, -1)),
                     ln - 1, window)
        n_pg = sum(-(-n // page) for n in lengths)
        return ((q, kpool, vpool, tbl, ln), library_args(q, kd, vd, ok),
                int(ok.sum()), 4 * (n_pg + b))

    def widened_sdpa(q, k, v, mask):
        return sdpa(q, k.to(torch.bfloat16), v.to(torch.bfloat16), mask)

    # (label, q dtype, heads, slots, lengths, window, K/V storage, timed)
    cases = [("g16 bf16", "bfloat16", GLM_HEADS, MAX_LEN, lens, None, None,
              True),
             ("g16 f32", "float32", GLM_HEADS, MAX_LEN, lens, None, None,
              True),
             ("g16 fp8 K/V", "bfloat16", GLM_HEADS, MAX_LEN, lens, None, f8,
              True),
             ("g16 S4096 window 1024", "bfloat16", GLM_HEADS, 4096,
              [4096, 3000, 100, 64], 1024, None, True),
             ("g16 row 1 without keys", "bfloat16", GLM_HEADS, MAX_LEN,
              no_keys, None, None, False),
             ("g16 fp8 K/V, row 1 without keys", "bfloat16", GLM_HEADS,
              MAX_LEN, no_keys, None, f8, False),
             ("g32 MQA bf16", "bfloat16", (32, 1), MAX_LEN, lens, None, None,
              True),
             ("g32 MQA f32", "float32", (32, 1), MAX_LEN, lens, None, None,
              True),
             ("g32 MQA fp8 K/V", "bfloat16", (32, 1), MAX_LEN, lens, None, f8,
              True),
             ("g32 MQA row 1 without keys", "float32", (32, 1), MAX_LEN,
              no_keys, None, None, False)]
    wrappers = {"decode_attention": (dense, decode_attention,
                                     decode_attention_ref),
                "paged_decode_attention": (paged, paged_decode_attention,
                                           paged_decode_attention_ref)}
    out = {}
    for wname, (make_case, kernel, plain) in wrappers.items():
        rows = out[wname] = {}
        for label, dtype, heads, S, lengths, window, kv, timed in cases:
            def make():
                return make_case(dtype, heads, S, lengths, window, kv)
            args, largs, n_tok, n_pos = make()
            kern = functools.partial(kernel, window=window)
            ref = functools.partial(plain, window=window)
            err = check_close(torch, wname, f"{label}, {heads[0]}/{heads[1]} "
                              f"heads", dtype, kern(*args), ref(*args),
                              empty=[i for i, n in enumerate(lengths)
                                     if n == 0])
            if not timed:
                rows[label] = dict(max_abs_err=err)
                continue
            q = args[0]
            elt = 1 if kv is not None else q.element_size()
            nbytes = (2 * n_tok * heads[1] * hd * elt
                      + 2 * q.numel() * q.element_size() + n_pos)
            r = timing(torch, (args, largs), lambda: make()[:2], kern, ref,
                       widened_sdpa if kv is not None else sdpa, nbytes,
                       4 * hd * heads[0] * n_tok,
                       peak=PEAK_F32 if dtype == "float32" else PEAK_BF16,
                       shape=f"{label}: b{len(lengths)} S{S} nq{heads[0]} "
                             f"nkv{heads[1]} hd{hd} {dtype} q"
                             + (", fp8 K/V" if kv is not None else "")
                             + f", lengths {lengths}"
                             + (f", window {window}" if window else ""))
            rows[label] = dict(max_abs_err=err, **r)
            log_timing(f"{wname} {label}", r)
            del args, largs
    release(torch)
    return out


def check_whisper_flash(torch, dev):
    """flash in whisper-base's two non-causal forms, against its plain
    version in bf16 and f32 and timed in bf16 (8 q / 8 kv heads, hd 64):
    the encoder's self-attention over its 1500 frames (b 1, s = S =
    1500), and the cross-attention of the decode step (b 4 slots, one
    query each, S 1500 encoder keys). The yardstick is SDPA with the same
    mask. Returns the two rows by name."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)

    gen = torch.Generator(device=dev).manual_seed(4321)
    nh, hd, t = 8, 64, 1500

    def case(dtype, b, s):
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, nh, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, t, nh, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, t, nh, hd), generator=gen, device=dev).to(dt)
        # the encoder's positions, or each decode slot's next position
        qp = (torch.arange(s, dtype=torch.int32, device=dev)[None]
              + torch.tensor([[0], [16], [32], [64]][:b], dtype=torch.int32,
                             device=dev)).contiguous()
        kp = torch.arange(t, dtype=torch.int32, device=dev).repeat(b, 1)
        return q, k, v, qp, kp

    def kernel(*a):
        return flash_attention(*a, causal=False)

    def plain(*a):
        return attention_ref(*a, causal=False)

    rows = {}
    for name, b, s in (("flash_whisper_encoder", 1, t),
                       ("flash_whisper_cross_decode", 4, 1)):
        errs = {}
        for dtype in ("bfloat16", "float32"):
            args = case(dtype, b, s)
            out = kernel(*args)
            errs[dtype] = check_close(torch, "flash_attention", name, dtype,
                                      out, plain(*args))
            check_lse(torch, name, dtype, flash_attention_with_lse,
                      attention_lse_ref, out, *args, None, False)

        def make():
            q, k, v, qp, kp = case("bfloat16", b, s)
            mask = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            return (q, k, v, qp, kp), (qt, kt, vt, mask[:, None])
        first = make()
        q, k, v, qp, kp = first[0]
        n_pairs = b * s * t
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (
            qp.numel() + kp.numel())
        rows[name] = dict(
            max_abs_err=errs["bfloat16"],
            **timing(torch, first, make, kernel, plain, sdpa, nbytes,
                     4 * hd * nh * n_pairs,
                     shape=f"b{b} s{s} S{t} nq{nh} nkv{nh} hd{hd} bf16, "
                           f"non-causal, {n_pairs} valid pairs"))
        log_timing(name, rows[name])
    return rows


# the backward rows of phase 2: name -> (b, s, S, nq, nkv, hd, window,
# causal, valid positions a row: queries and, where S = s, keys); the first
# is phase 7t's training shape
BWD_CASES = {
    "smollm causal": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 9, 3, 64, None, True,
                      2048),
    "mistral causal": (1, 2048, 2048, 32, 8, 128, None, True, 2048),
    "whisper encoder, non-causal": (1, 1500, 1500, 8, 8, 64, None, False,
                                    1500),
    "mistral window 256": (1, 1024, 1024, 32, 8, 128, 256, True, 1024),
    "smollm padded rows 1900 of 2048": (2, 2048, 2048, 9, 3, 64, None, True,
                                        1900),
    # whisper's decoder cross-attention in training: its 448-token context
    # over the encoder's 1500 frames, 4 sequences
    "whisper decoder cross, non-causal": (4, 448, 1500, 8, 8, 64, None, False,
                                          448),
    # a glm4-9b rank at 1 x 4 in phase 7r: its 8 q heads over one gathered
    # kv head of 128, 2 sequences of 2048
    "glm4 rank at 1 x 4, causal": (2, 2048, 2048, 8, 1, 128, None, True,
                                   2048),
}


def check_flash_bwd(torch, dev):
    """flash_attention_bwd against the autograd gradient of the plain
    version on the card, at the training shapes of BWD_CASES, in bf16 and
    f32, fed the forward's output and log-sum-exp: dq, dk and dv within
    TOL (reference magnitude printed), padded query rows 0, two calls
    bitwise equal. Each case is timed in bf16 (the smollm case in f32 too)
    with a bound of 2.5 times the forward's two products (the scores
    recomputed, dP, dV, dK, dQ) over the peak of its dtype, and as its
    yardstick the backward of SDPA on the same inputs (``autograd.grad``
    of its output, the graph kept). Returns the rows by case."""
    from torch.nn import functional as F

    from repro_torch.kernels.flash_attention.backward import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_with_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(2468)

    def inputs(case, dtype):
        b, s, S, nq, nkv, hd, win, causal, n_valid = case
        dt = getattr(torch, dtype)
        q, k, v, dout = (
            torch.randn(shape, generator=gen, device=dev).to(dt)
            for shape in ((b, s, nq, hd), (b, S, nkv, hd), (b, S, nkv, hd),
                          (b, s, nq, hd)))
        i = torch.arange(s, dtype=torch.int32, device=dev)
        qp = torch.where(i < n_valid, i, torch.full_like(i, -1)).repeat(
            b, 1).contiguous()
        kp = qp if S == s else torch.arange(
            S, dtype=torch.int32, device=dev).repeat(b, 1).contiguous()
        out, lse = flash_attention_with_lse(q, k, v, qp, kp, window=win,
                                            causal=causal)
        return q, k, v, out, dout, lse, qp, kp

    def library_set(args, case):
        """SDPA's forward on the same inputs, its graph kept for repeated
        backwards: flash's function, with is_causal where the mask is the
        plain causal one and a boolean mask elsewhere."""
        q, k, v, _, dout, _, qp, kp = args
        _, s, _, _, _, _, win, causal, n_valid = case
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        kw = {}
        if win is not None or n_valid < s:
            valid = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
            if causal:
                valid &= kp[:, None, :] <= qp[:, :, None]
                if win is not None:
                    valid &= kp[:, None, :] > qp[:, :, None] - win
            kw["attn_mask"] = valid[:, None]
        elif causal:
            kw["is_causal"] = True
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                 **kw)
        return out, (qt, kt, vt), dout.transpose(1, 2).contiguous()

    def library(out, leaves, dout):
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    rows = {}
    for name, case in BWD_CASES.items():
        b, s, S, nq, nkv, hd, win, causal, n_valid = case
        kw = dict(window=win, causal=causal)

        def kernel(q, k, v, out, dout, lse, qp, kp):
            return flash_attention_bwd(q, k, v, out, dout, lse, qp, kp, **kw)

        def plain(q, k, v, out, dout, lse, qp, kp):
            return attention_bwd_ref(q, k, v, qp, kp, dout, **kw)

        errs = {}
        for dtype in ("bfloat16", "float32"):
            args = inputs(case, dtype)
            got = kernel(*args)
            again = kernel(*args)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            want = plain(*args)
            zero = bool((got[0][:, n_valid:] == 0).all())
            parts = []
            for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                ok = torch.allclose(g.float(), w.float(), **TOL[dtype])
                parts.append(f"{g_name} {err:.3e} (max |ref| "
                             f"{w.float().abs().max().item():.3e})"
                             f"{'' if ok else ' FAIL'}")
                assert ok and torch.isfinite(g.float()).all(), (
                    name, dtype, g_name, err)
                errs[dtype] = max(errs.get(dtype, 0.0), err)
            log(f"  flash_attention_bwd [{name}] {dtype}: max_abs_err "
                f"{'; '.join(parts)} tol={TOL[dtype]}; padded rows' dq 0: "
                f"{zero}; two calls bitwise equal: {same}")
            assert same and zero, (name, dtype, same, zero)
            del args, got, again, want
            release(torch)

        timed = ("bfloat16", "float32") if name == "smollm causal" else (
            "bfloat16",)
        for dtype in timed:
            def make():
                args = inputs(case, dtype)
                return args, library_set(args, case)
            first = make()
            q, k, v, _, _, lse, qp, kp = first[0]
            valid = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
            if causal:
                valid &= kp[:, None, :] <= qp[:, :, None]
                if win is not None:
                    valid &= kp[:, None, :] > qp[:, :, None] - win
            n_pairs = int(valid.sum().item())
            del valid
            el = q.element_size()
            # q, out, dout, dq; k, v, dk, dv; lse; positions
            nbytes = el * 4 * (q.numel() + k.numel()) + 4 * (
                lse.numel() + qp.numel() + kp.numel())
            flops = 2.5 * 4 * hd * nq * n_pairs
            if dtype == "bfloat16" and name == "smollm causal":
                n_dev = device_kernels(torch, lambda: kernel(*first[0]))
                log(f"  flash_attention_bwd: {n_dev} device kernels a call")
                assert n_dev == 3, n_dev
            r = timing(torch, first, make, kernel, plain, library, nbytes,
                       flops, plain_n=5,
                       peak=PEAK_BF16 if dtype == "bfloat16" else PEAK_F32,
                       shape=f"{name}: b{b} s{s} S{S} nq{nq} nkv{nkv} hd{hd} "
                             f"{'bf16' if dtype == 'bfloat16' else 'f32'}, "
                             f"{n_pairs} valid pairs, {flops / 1e9:.2f} "
                             f"GFLOP")
            r["max_abs_err"] = errs[dtype]
            log_timing(f"flash_attention_bwd {name} {dtype}", r)
            rows[name if dtype == "bfloat16" else f"{name} f32"] = r
            del first
            release(torch)
    return rows


def check_ssd(torch, dev):
    """ssd_scan against its plain version at mamba2-370m's prefill shape
    (B 1, S 2048, H 32, P 64, N 128, chunk 256), a single chunk and two
    rows of which one is padded; the device kernels one call issues. The
    same at a rank's share of the heads under tensor parallelism at 1 x 2
    (H 16, phase 3t's mamba2 run): checked and timed, under "rank"."""
    from repro_torch.kernels.ssd_scan import kernel as SSD
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(4321)
    B, S, H, P, N, chunk = 1, SSM_MAX_LEN, 32, 64, 128, 256

    def inputs(dtype, s=S, init=False, n_pad=0, bsz=B, pad_rows=None,
               heads=H):
        dt_ = getattr(torch, dtype)

        def randn(shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=dev)

        dt = torch.nn.functional.softplus(randn((bsz, s, heads)))
        if n_pad:
            dt[pad_rows if pad_rows is not None else slice(None), -n_pad:] = 0
        return (randn((bsz, s, heads, P)).to(dt_), dt,
                -torch.exp(randn((heads,), 0.3)),
                randn((bsz, s, N), 0.3).to(dt_),
                randn((bsz, s, N), 0.3).to(dt_),
                torch.ones((heads,), device=dev),
                randn((bsz, heads, P, N), 0.1) if init else
                torch.zeros((bsz, heads, P, N), device=dev))

    errs, rank_errs = [], []
    for label, dtype, kw in [
            ("S2048", "bfloat16", {}),
            ("S2048", "float32", {}),
            ("S2048 init state", "bfloat16", dict(init=True)),
            ("S2048 dt=0 over the last 100", "bfloat16", dict(n_pad=100)),
            ("S96 one chunk of 96", "bfloat16", dict(s=96)),
            ("B2 S2048 init, dt=0 over the last 700 of row 1 only",
             "bfloat16", dict(bsz=2, init=True, n_pad=700, pad_rows=[1])),
            ("S2048 H16, a rank's heads at 1 x 2", "bfloat16",
             dict(heads=H // 2, init=True))]:
        args = inputs(dtype, **kw)
        c = min(chunk, args[0].shape[1])
        y, fin = ssd_scan(*args[:6], c, args[6])
        yr, fr = ssd_chunked(*args[:6], c, args[6])
        err = (y.float() - yr.float()).abs().max().item()
        serr = (fin - fr).abs().max().item()
        ok = (torch.allclose(y.float(), yr.float(), **TOL[dtype])
              and torch.allclose(fin, fr, **SSD_STATE_TOL))
        log(f"  ssd_scan [{label}] {dtype}: y max_abs_err={err:.3e} "
            f"(max |y_ref| {yr.float().abs().max().item():.3e}) "
            f"tol={TOL[dtype]}; state max_abs_err={serr:.3e} "
            f"tol={SSD_STATE_TOL} {'ok' if ok else 'FAIL'}")
        assert ok and torch.isfinite(y.float()).all(), (label, err, serr)
        if dtype == "bfloat16":
            (rank_errs if "heads" in kw else errs).append(err)

    def timed(heads):
        """The serving path's call at ``heads`` heads: bf16, the fresh
        cache's zero state as init."""
        def make():
            args = inputs("bfloat16", heads=heads)
            return (*args[:6], chunk, args[6]), None
        first = make()
        x = first[0][0]
        n_dev = device_kernels(torch, lambda: ssd_scan(*first[0]))
        log(f"  ssd_scan H{heads}: {n_dev} device kernels a call")
        assert n_dev == SSD.DEVICE_KERNELS, (n_dev, SSD.DEVICE_KERNELS)
        # work of the kernel's own 64-token sub-chunks: C·Bᵀ and the
        # intra-chunk product over lower-triangular pairs, the inter-chunk
        # term and the state update over every (token, p, n)
        sub = 64
        pairs = sum(n * (n + 1) // 2 for n in
                    [sub] * (S // sub) + ([S % sub] if S % sub else []))
        flops = 2 * pairs * (N + heads * P) + 2 * 2 * heads * S * P * N
        nbytes = (2 * 2 * x.numel() + 2 * 2 * B * S * N + 4 * B * S * heads
                  + 4 * 2 * heads + 4 * 2 * B * heads * P * N)
        # library_ms None: no single PyTorch call computes the SSD scan
        return dict(device_kernels=n_dev, **timing(
            torch, first, make, ssd_scan, ssd_chunked, None, nbytes, flops,
            plain_n=20, shape=f"B{B} S{S} H{heads} P{P} N{N} chunk{chunk} "
                              f"bf16, {flops / 1e9:.3f} GFLOP, "
                              f"{nbytes / 1e6:.2f} MB"))

    res = dict(max_abs_err=max(errs), **timed(H))
    log_timing("ssd_scan", res)
    res["rank"] = dict(max_abs_err=max(rank_errs), **timed(H // 2))
    log_timing("ssd_scan at a rank's heads", res["rank"])
    return res


# the rows of ssd_scan_bwd in phase 2: name -> (B, S, H, P, N, the
# caller's chunk, an initial state and a nonzero final-state gradient);
# the first is mamba2-370m's training shape in phase 7t, the second a
# rank's heads at 1 x 2 in phase 7r, the last small ones hold both ends of
# the reverse recurrence, a ragged last chunk of the kernel's (320 tokens
# over its 256-token chunks in bf16), a head dim of two slices (96) and
# the smallest state dim
SSD_BWD_CASES = {
    "mamba2 train": (TRAIN_BATCH, TRAIN_SEQ, 32, 64, 128, 256, False),
    "mamba2 rank at 1 x 2": (TRAIN_BATCH, TRAIN_SEQ, 16, 64, 128, 256, False),
    "init + dfinal, ragged": (2, 320, 4, 96, 64, 320, True),
    "init + dfinal, N16": (1, 192, 3, 32, 16, 64, True),
}
SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd_skip", "dinit")


def check_ssd_bwd(torch, dev):
    """ssd_scan_bwd against the plain version of its arithmetic
    (``ref.ssd_chunked_bwd``, which recomputes the states at the caller's
    chunk) on the card's tensors, at SSD_BWD_CASES in bf16 and f32, fed
    the forward kernel's states before each of its chunks: each of the
    seven gradients within TOL (max |plain| printed beside its error), two
    calls bitwise equal; in f32 against the plain version run in f64 on
    the same values (its f32 run's own distance from that printed). The two training shapes timed in bf16 (the first
    in f32 too), with a bound of the bytes it must move (x, dy, dx, B, C,
    their gradients, dt, ddt, the forward's states) and its products over
    64-token sub-chunks, as ``check_ssd`` counts the forward's; no single
    PyTorch call computes it (library_ms None). Returns the rows by
    case."""
    from repro_torch.kernels.ssd_scan import backward as SB
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_with_states
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

    gen = torch.Generator(device=dev).manual_seed(8642)

    def inputs(case, dtype):
        bsz, s, heads, P, N, chunk, ends = case
        dt_ = getattr(torch, dtype)

        def randn(shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=dev)

        x = randn((bsz, s, heads, P)).to(dt_)
        dt = torch.nn.functional.softplus(randn((bsz, s, heads)))
        a = -torch.exp(randn((heads,), 0.3))
        b, c = (randn((bsz, s, N), 0.3).to(dt_) for _ in range(2))
        d = torch.ones((heads,), device=dev)
        init = randn((bsz, heads, P, N), 0.1) if ends else None
        dy = randn((bsz, s, heads, P)).to(dt_)
        dfinal = randn((bsz, heads, P, N), 0.1) if ends else None
        prev = ssd_scan_with_states(x, dt, a, b, c, d, chunk, init)[2]
        return x, dt, a, b, c, d, chunk, init, prev, dy, dfinal

    def plain(x, dt, a, b, c, d, chunk, init, prev, dy, dfinal, f64=False):
        """The plain version at the kernel's own chunk where it divides the
        sequence: the same decomposition (in f32 a 320-token chunk's
        reverse sums round 7e-4 away from f64 where 64-token chunks stay
        within 1e-4). ``f64``: on the same values in f64, what an f32 row
        is held to (the plain version's own f32 sums over 8192 tokens and
        32 heads round farther than 1e-4 from it)."""
        own = SK.plan(*x.shape, b.shape[-1], x.dtype).chunk
        args = [x, dt, a, b, c, d, own if x.shape[1] % own == 0 else chunk,
                init, None, dy, dfinal]
        if f64:
            args = [t.double() if isinstance(t, torch.Tensor) else t
                    for t in args]
        return ssd_chunked_bwd(*args)

    rows = {}
    for name, case in SSD_BWD_CASES.items():
        bsz, s, heads, P, N, chunk, ends = case
        errs = {}
        for dtype in ("bfloat16", "float32"):
            args = inputs(case, dtype)
            got = SB.ssd_scan_bwd(*args)
            again = SB.ssd_scan_bwd(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            want = plain(*args, f64=dtype == "float32")
            drift = ""
            if dtype == "float32":
                own = plain(*args)
                drift = "; the plain version in f32 against f64: " + ", ".join(
                    f"{n} {(o.double() - w).abs().max().item():.3e}"
                    for n, o, w in zip(SSD_GRADS, own, want))
                del own
            parts, bad = [], []
            for g_name, g, w in zip(SSD_GRADS, got, want):
                g, w = g.double(), w.double()
                err = (g - w).abs().max().item()
                ok = (torch.allclose(g, w, **TOL[dtype])
                      and bool(torch.isfinite(g).all()))
                parts.append(f"{g_name} {err:.3e} (max |plain| "
                             f"{w.abs().max().item():.3e})"
                             f"{'' if ok else ' FAIL'}")
                if not ok:
                    bad.append(g_name)
                errs[dtype] = max(errs.get(dtype, 0.0), err)
            log(f"  ssd_scan_bwd [{name}: B{bsz} S{s} H{heads} P{P} N{N}"
                f"{', init + dfinal' if ends else ''}] {dtype}: max_abs_err "
                f"{'; '.join(parts)} tol={TOL[dtype]}"
                f"{' (against the plain version in f64)' if drift else ''}; "
                f"two calls bitwise equal: {same}{drift}")
            assert same and not bad, (name, dtype, bad)
            del args, got, again, want
            release(torch)
        if name not in ("mamba2 train", "mamba2 rank at 1 x 2"):
            continue
        timed = ("bfloat16", "float32") if name == "mamba2 train" else (
            "bfloat16",)
        for dtype in timed:
            def make():
                return inputs(case, dtype), None
            first = make()
            x, prev = first[0][0], first[0][8]
            el = x.element_size()
            if dtype == "bfloat16" and name == "mamba2 train":
                n_dev = device_kernels(torch,
                                       lambda: SB.ssd_scan_bwd(*first[0]))
                log(f"  ssd_scan_bwd: {n_dev} device kernels a call")
                assert n_dev == SB.DEVICE_KERNELS, n_dev
                rows["device_kernels"] = n_dev
            # x, dy, dx; B, C, dB, dC; dt, ddt; the forward's states
            nbytes = (el * (3 * x.numel() + 4 * bsz * s * N)
                      + 4 * 2 * bsz * s * heads + prev.numel() * el)
            sub = 64
            pairs = bsz * sum(n * (n + 1) // 2 for n in [sub] * (s // sub)
                              + ([s % sub] if s % sub else []))
            # C.B^T, dy.x^T, the scores' transpose times dy, dC and dB
            # from the head-summed weights; the state terms (S^T dy, G B,
            # G^T xdt and each chunk's own state gradient) every token
            flops = (2 * pairs * (3 * N + 2 * heads * P)
                     + 2 * 4 * bsz * s * heads * P * N)
            r = timing(torch, first, make, SB.ssd_scan_bwd, plain, None,
                       nbytes, flops, plain_n=3,
                       peak=PEAK_BF16 if dtype == "bfloat16" else PEAK_F32,
                       shape=f"{name}: B{bsz} S{s} H{heads} P{P} N{N} "
                             f"{'bf16' if dtype == 'bfloat16' else 'f32'}, "
                             f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} "
                             f"MB")
            r["max_abs_err"] = errs[dtype]
            log_timing(f"ssd_scan_bwd {name} {dtype}", r)
            rows[name if dtype == "bfloat16" else f"{name} f32"] = r
            del first
            release(torch)
    return rows


# ---------------------------------------------------------------------------
# phase 3: model parity, CPU plain versions vs GPU kernels
# ---------------------------------------------------------------------------

def model_parity(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import frontend as FE
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.layers import to_kv
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import (cache_tensors, clone_caches,
                                                make_caches)

    base = get_config("llava-next-mistral-7b")
    cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
    f8 = torch.float8_e4m3fn
    params_cpu = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu", dtype=torch.float32)
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    mm_pos, n_text = 8, 40
    n = n_text + IMAGE_TOKENS
    text = [(7 * i + 3) % cfg.vocab for i in range(n_text)]
    toks = torch.zeros((1, MAX_LEN), dtype=torch.int32)
    toks[0, :mm_pos] = torch.tensor(text[:mm_pos])
    toks[0, mm_pos + IMAGE_TOKENS:n] = torch.tensor(text[mm_pos:])
    patches = FE.stub_embeddings(cfg, b"chip-smoke-image", IMAGE_TOKENS)
    forced = [5, 17, 42, 99]

    def run(params, device, layout, kv_dtype, prefilled=None, f32=None):
        """Logits of the prefill and the forced decode steps, and the
        caches as the prefill left them. ``prefilled``: caches whose fp8
        K/V the decode steps read instead of this prefill's own, after
        ``check_fp8`` has held this prefill's fp8 bytes against them and
        against ``f32``, the two sides' caches of the f32 run."""
        feats = (patches.to(device) @ params["projector"]).float()[None]
        kw = {}
        if layout == "paged":
            kw = dict(layout="paged", page_size=16, n_pages=1 + MAX_LEN // 16)
        caches = make_caches(cfg, 1, MAX_LEN, dtype=torch.float32,
                             kv_dtype=kv_dtype, device=device, **kw)
        if layout == "paged":
            caches["pages"][0] = torch.arange(1, 1 + MAX_LEN // 16,
                                              dtype=torch.int32)
        logits, caches = prefill_forward(
            params, cfg, toks.to(device), caches,
            lengths=torch.tensor([n], dtype=torch.int32, device=device),
            mm_feats=feats, mm_start=mm_pos)
        out = [logits.cpu()]
        after = clone_caches(caches)
        if prefilled is not None:
            check_fp8(layout, caches, prefilled, *f32)
            for mine, theirs in zip(cache_tensors(caches),
                                    cache_tensors(prefilled)):
                if mine.dtype == f8:
                    mine.copy_(theirs.to(device))
        for t in forced:
            logits, caches = decode_forward(
                params, cfg, torch.tensor([t], dtype=torch.int32,
                                          device=device), caches)
            out.append(logits.cpu())
        return out, after

    def check_fp8(layout, gpu, cpu, cpu32, gpu32):
        """The GPU prefill's fp8 K/V bytes are ``to_kv`` on the CPU (the
        reference's cast, held bitwise to JAX's by the CPU tests) of the
        GPU's own f32 K/V from the f32 run; where they differ from the
        CPU prefill's bytes, the f32 K/V behind them differ bitwise (the
        two sides' f32 runs, +0 and -0 counted apart; or the CPU's f32
        and fp8 prefills, whose f32 K/V the CPU need not repeat to the
        bit) and the bytes are neighbouring values (+0 and -0 being
        one). Page 0 (trash) of a pool is not compared."""
        trash = 1 if layout == "paged" else 0
        n_diff = n_zero = n_all = n_cpu = 0
        for g8, c8, c32, g32 in zip(cache_tensors(gpu), cache_tensors(cpu),
                                    cache_tensors(cpu32), gpu32):
            if g8.dtype != f8:
                continue
            g8, c8 = g8[trash:].cpu().view(torch.uint8), c8[trash:].view(
                torch.uint8)
            c32, g32 = c32[trash:], g32[trash:]
            want = to_kv(g32, f8).view(torch.uint8)
            bad = int((g8 != want).sum())
            assert bad == 0, (layout, "GPU fp8 bytes != to_kv of its f32 "
                              "K/V", bad)
            cpu_moved = c8 != to_kv(c32, f8).view(torch.uint8)
            steps = (value_order(c8[cpu_moved])
                     - value_order(to_kv(c32, f8).view(torch.uint8)[
                         cpu_moved])).abs()
            assert bool((steps <= 1).all()), (layout, "CPU prefills",
                                              steps.max().item())
            diff = g8 != c8
            moved = (c32.view(torch.int32) != g32.view(torch.int32)) | \
                cpu_moved
            assert bool(moved[diff].all()), (
                layout, "fp8 bytes differ where the f32 K/V agree",
                int((diff & ~moved).sum()))
            steps = (value_order(g8[diff]) - value_order(c8[diff])).abs()
            assert bool((steps <= 1).all()), (layout, steps.max().item())
            n_diff += int(diff.sum())
            n_zero += int((steps == 0).sum())
            n_all += diff.numel()
            n_cpu += int(cpu_moved.sum())
        log(f"    {layout} fp8: the GPU's K/V bytes equal to_kv of its f32 "
            f"K/V; {n_diff} of {n_all} bytes differ from the CPU prefill's "
            f"where the f32 K/V differ, each a neighbouring value ({n_zero} "
            f"of them +0 against -0); {n_cpu} bytes of the CPU's fp8 "
            f"prefill differ from to_kv of its f32 prefill, each a "
            f"neighbouring value; the GPU decodes over the CPU's")

    def value_order(b):
        """e4m3 bytes as their rank on the number line (+0 and -0 one
        value), so that neighbouring values differ by 1."""
        mag = (b & 0x7F).int()
        return torch.where(b >= 0x80, -mag, mag)

    # the cast at the edges, from f32 and bf16: the GPU's to_kv (NaN past
    # 464, never Tensor.to's saturation to 448) is the CPU's, bitwise
    edges = torch.tensor([0.0, 448.0, 464.0, 465.0, 480.0, 1e4, float("inf"),
                          float("nan"), 2.0 ** -9, 1.5 * 2.0 ** -9, 0.3, 1.7])
    edges = torch.cat([edges, -edges, 300 * torch.randn(
        4096, generator=torch.Generator().manual_seed(3))])
    for dt in (torch.float32, torch.bfloat16):
        x = edges.to(dt)
        same = torch.equal(to_kv(x.to(dev), f8).cpu().view(torch.uint8),
                           to_kv(x, f8).view(torch.uint8))
        log(f"  to_kv {dt} -> e4m3 on the GPU == on the CPU, bitwise: {same}")
        assert same, dt

    # f32 caches, then K/V stored in fp8 (the decode kernels read them
    # as they are; flash gets the unrounded prefill K/V). The two
    # prefills' fp8 bytes differ wherever the CPU's and the GPU's f32 K/V
    # straddle a rounding boundary (check_fp8), so with fp8 the GPU's
    # decode steps read the CPU prefill's cache: both sides decode over
    # the same bytes
    f32_caches = {}
    for layout, kv_dtype in (("dense", None), ("paged", None),
                             ("dense fp8", f8), ("paged fp8", f8)):
        kind = layout.split()[0]
        t0 = time.perf_counter()
        ref, prefilled = run(params_cpu, "cpu", kind, kv_dtype)
        t1 = time.perf_counter()
        got, after = run(params_gpu, dev, kind, kv_dtype,
                         prefilled if kv_dtype == f8 else None,
                         f32_caches.get(kind))
        torch.cuda.synchronize()
        if kv_dtype is None:
            f32_caches[kind] = (prefilled,
                                [t.cpu() for t in cache_tensors(after)])
        del after
        for i, (a, b) in enumerate(zip(got, ref)):
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, **PARITY_TOL)
            log(f"  {layout} step {i}: logits max_abs_err={err:.3e} "
                f"tol={PARITY_TOL} {'ok' if ok else 'FAIL'}")
            assert ok and torch.isfinite(a).all(), (layout, i, err)
        log(f"  {layout}: cpu {t1 - t0:.1f} s, gpu "
            f"{time.perf_counter() - t1:.1f} s")
    del params_gpu
    release(torch)


def ssm_parity(torch, dev):
    """mamba2-370m at full width, 2 layers, f32: a 1000-token prompt padded
    to 2048 (the engine's dense prefill) and 4 teacher-forced decode steps
    on the CPU (plain SSD scan) and on the GPU (the ssd_scan kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import make_caches

    base = get_config("mamba2-370m")
    cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
    params_cpu = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu", dtype=torch.float32)
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    n = 1000
    toks = torch.zeros((1, SSM_MAX_LEN), dtype=torch.int32)
    toks[0, :n] = torch.tensor([(7 * i + 3) % cfg.vocab for i in range(n)])
    forced = [5, 17, 42, 99]

    def run(params, device):
        caches = make_caches(cfg, 1, SSM_MAX_LEN, dtype=torch.float32,
                             device=device)
        logits, caches = prefill_forward(
            params, cfg, toks.to(device), caches,
            lengths=torch.tensor([n], dtype=torch.int32, device=device))
        out = [logits.cpu()]
        for t in forced:
            logits, caches = decode_forward(
                params, cfg, torch.tensor([t], dtype=torch.int32,
                                          device=device), caches)
            out.append(logits.cpu())
        return out

    t0 = time.perf_counter()
    ref = run(params_cpu, "cpu")
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    got = run(params_gpu, dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["ssd_scan"]
    assert launches == cfg.n_layers, launches     # one scan a layer
    for i, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs().max().item()
        ok = torch.allclose(a, b, **PARITY_TOL)
        log(f"  step {i}: logits max_abs_err={err:.3e} (max |logit| "
            f"{b.abs().max().item():.3e}) tol={PARITY_TOL} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok and torch.isfinite(a).all(), (i, err)
    log(f"  cpu {t1 - t0:.1f} s, gpu {time.perf_counter() - t1:.1f} s, "
        f"{launches} ssd_scan launches")
    del params_gpu
    release(torch)


def moe_parity(torch, dev):
    """mixtral-8x7b at full width, 2 layers, f32, capacity factor 1.25: a
    4352-token prompt (past the 4096 window) padded to 4608, then 4
    teacher-forced decode steps, dense and paged, on the CPU (plain
    versions) and on the GPU (kernels), layer by layer: each GPU layer is
    fed the CPU's input, so that a routing flip stays in its layer. The
    top-k experts and the kept selections of every MoE layer must agree,
    except at a token where two neighbouring probabilities among the
    CPU's top k + 1 lie within MOE_MARGIN (a near-tie that the two sides'
    f32 rounding may break either way) and, in a layer with such a flip,
    at the selections it pushed past or into capacity. Layer outputs and
    logits are held to PARITY_TOL at every token whose routing agrees."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import lm_logits, make_caches

    base = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    params_gpu = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                             device=dev, dtype=torch.float32)
    params_cpu = map_tree(lambda t: t.cpu(), params_gpu)
    n, S = MOE_PROMPT, MOE_PARITY_LEN
    toks = torch.zeros((1, S), dtype=torch.int32)
    toks[0, :n] = torch.tensor([(7 * i + 3) % cfg.vocab for i in range(n)])
    forced = [5, 17, 42, 99]

    def layer(params, r, h, positions, caches):
        """One decoder layer (windowed attention, then MoE) over the cache
        views of repeat ``r``, as ``run_decoder`` runs it; returns its
        output, the top-k experts and the kept mask in token order."""
        blk = params["blocks"][0]
        pa = {kk: t[r] for kk, t in blk["attn"].items()}
        pm = {kk: t[r] for kk, t in blk["moe"].items()}
        c = caches["attn"][0]
        h, _ = L.attention_block(pa, h, positions, cfg,
                                 window=cfg.sliding_window,
                                 cache=tuple(t[r] for t in c),
                                 cur_len=caches["len"],
                                 pages=caches.get("pages"))
        probs, _, eidx = MOE.route(pm, L.rms_norm(h, pm["norm"],
                                                  cfg.norm_eps), cfg)
        sort_idx, _, pos, _, _ = MOE.dispatch(eidx, E)
        keep = torch.zeros_like(pos, dtype=torch.bool).scatter_(
            1, sort_idx, pos < MOE.capacity(cfg, h.shape[1]))
        out, _ = MOE.moe_block(pm, h, cfg)
        return out, probs, eidx, keep.reshape(eidx.shape)

    def compare(label, got, ref, valid):
        """GPU layer output ``got`` (fed the CPU's input) against the CPU's
        ``ref``; returns the rows whose routing agrees."""
        out_g, _, eidx_g, keep_g = (t.cpu() for t in got)
        out_c, probs_c, eidx_c, keep_c = ref
        top = torch.topk(probs_c, k + 1, dim=-1).values
        margin = (top[..., :-1] - top[..., 1:]).min(-1).values
        flip = (eidx_g != eidx_c).any(-1) & valid
        kept = (keep_g != keep_c).any(-1) & valid & ~flip
        near = flip & (margin < MOE_MARGIN)
        assert bool((near == flip).all()), (
            label, "routing flip at a margin >= MOE_MARGIN",
            margin[flip & ~near].tolist())
        assert not bool(kept.any()) or bool(flip.any()), (
            label, "kept selections differ with no routing flip",
            int(kept.sum()))
        agree = valid & ~flip & ~kept
        err = (out_g - out_c).abs()[agree].max().item()
        ok = torch.allclose(out_g[agree], out_c[agree], **PARITY_TOL)
        flips.append((label, int(flip.sum()), int(kept.sum())))
        log(f"    {label}: output max_abs_err={err:.3e} over "
            f"{int(agree.sum())} tokens, routing flips {int(flip.sum())} "
            f"(margins {[f'{m:.2e}' for m in margin[flip].tolist()]}), kept "
            f"changed {int(kept.sum())}, drops on the CPU "
            f"{int((~keep_c & valid[..., None]).sum())} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok and torch.isfinite(out_g[agree]).all(), (label, err)
        return agree

    def logits(params, h, last):
        h = L.rms_norm(h[:, last:last + 1], params["final_norm"],
                       cfg.norm_eps)
        return lm_logits(params, cfg, h)[:, 0].float()

    def run(layout):
        kw = {}
        if layout == "paged":
            kw = dict(layout="paged", page_size=16, n_pages=1 + S // 16)
        sides = []
        for device in ("cpu", dev):
            caches = make_caches(cfg, 1, S, dtype=torch.float32,
                                 device=device, **kw)
            if layout == "paged":
                caches["pages"][0] = torch.arange(1, 1 + S // 16,
                                                  dtype=torch.int32)
            sides.append(caches)
        idx = torch.arange(S, dtype=torch.int32)[None]
        steps = [(params_cpu["embed"][toks.long()],
                  torch.where(idx < n, idx, torch.full_like(idx, -1)), n - 1)]
        steps += [(params_cpu["embed"][torch.tensor([[t]])],
                   torch.tensor([[n + i]], dtype=torch.int32), 0)
                  for i, t in enumerate(forced)]
        for step, (x, positions, last) in enumerate(steps):
            valid = positions >= 0
            h_cpu = x
            for r in range(cfg.n_repeats):
                ref = layer(params_cpu, r, h_cpu, positions, sides[0])
                got = layer(params_gpu, r, h_cpu.to(dev), positions.to(dev),
                            sides[1])
                agree = compare(f"{layout} step {step} layer {r}", got, ref,
                                valid)
                h_cpu = ref[0]
            a = logits(params_gpu, got[0], last).cpu()
            b = logits(params_cpu, h_cpu, last)
            if bool(agree[0, last]):
                err = (a - b).abs().max().item()
                ok = torch.allclose(a, b, **PARITY_TOL)
                log(f"  {layout} step {step}: logits max_abs_err={err:.3e} "
                    f"tol={PARITY_TOL} {'ok' if ok else 'FAIL'}")
                assert ok and torch.isfinite(a).all(), (layout, step, err)
            else:
                log(f"  {layout} step {step}: last token's routing flipped "
                    f"in the last layer; logits not compared")
            for caches in sides:
                caches["len"].fill_(n + step)

    flips = []
    ops.reset_launch_counts()
    for layout in ("dense", "paged"):
        t0 = time.perf_counter()
        run(layout)
        log(f"  {layout}: {time.perf_counter() - t0:.1f} s (cpu and gpu)")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  launches {counts}; routing flips (label, flips, kept changed) "
        f"{[f for f in flips if f[1] or f[2]]}, in all "
        f"{sum(f[1] for f in flips)}")
    steps = 1 + len(forced)
    assert counts["flash_attention"] == 2 * cfg.n_layers, counts
    assert counts["decode_attention"] == len(forced) * cfg.n_layers, counts
    assert counts["paged_decode_attention"] == len(forced) * cfg.n_layers
    assert len(flips) == 2 * steps * cfg.n_layers
    del params_gpu
    release(torch)


def whisper_parity(torch, dev):
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers over 1500 frames), f32: the prefill of a 40-token prompt
    padded to WHISPER_MAX_LEN, then 8 greedy decode steps, on the CPU
    (plain versions) and on the GPU (kernels). Compared: the encoder
    output, each layer's cross-KV, each layer's output (encoder and
    decoder layers of the prefill, decoder layers of every step: the
    outputs of their MLP blocks), the logits and the greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import frontend as FE
    from repro_torch.models import layers as L
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import make_caches, run_encoder

    cfg = get_config("whisper-base")
    params_cpu = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu", dtype=torch.float32)
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    frames = FE.stub_embeddings(cfg, b"chip-smoke audio")[None]
    n = 40
    toks = torch.zeros((1, WHISPER_MAX_LEN), dtype=torch.int32)
    toks[0, :n] = torch.tensor([(7 * i + 3) % cfg.vocab for i in range(n)])
    mlp = L.mlp_block

    def run(params, device):
        layer_out = []

        def recorded(p, x, cfg_):
            y = mlp(p, x, cfg_)
            layer_out.append(y.cpu())
            return y

        enc = run_encoder(params, cfg, frames.to(device))[0].cpu()
        L.mlp_block = recorded
        try:
            caches = make_caches(cfg, 1, WHISPER_MAX_LEN, dtype=torch.float32,
                                 device=device)
            logits, caches = prefill_forward(
                params, cfg, toks.to(device), caches,
                lengths=torch.tensor([n], dtype=torch.int32, device=device),
                enc_frames=frames.to(device))
            cross = [t.cpu() for t in caches["cross"]]
            out, tokens = [logits.cpu()], []
            for _ in range(8):
                tokens.append(int(torch.argmax(logits[0])))
                logits, caches = decode_forward(
                    params, cfg, torch.tensor(tokens[-1:], dtype=torch.int32,
                                              device=device), caches)
                out.append(logits.cpu())
        finally:
            L.mlp_block = mlp
        return enc, cross, layer_out, out, tokens

    t0 = time.perf_counter()
    ref = run(params_cpu, "cpu")
    t1 = time.perf_counter()
    got = run(params_gpu, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def check(label, a, b):
        err = (a - b).abs().max().item()
        ok = torch.allclose(a, b, **PARITY_TOL) and bool(
            torch.isfinite(a).all())
        assert ok, (label, err)
        return err

    err = check("encoder output", got[0], ref[0])
    log(f"  encoder output {tuple(got[0].shape)}: max_abs_err={err:.3e}")
    errs = [check(f"cross {name} layer {r}", g[r], c[r])
            for name, g, c in zip(("k", "v"), got[1], ref[1])
            for r in range(cfg.n_layers)]
    assert torch.equal(got[1][2], ref[1][2])
    log(f"  cross-KV of {cfg.n_layers} layers: max_abs_err={max(errs):.3e}; "
        f"enc_pos equal")
    n_enc = cfg.encoder.n_layers
    assert len(got[2]) == len(ref[2]) == n_enc + 9 * cfg.n_layers
    errs = [check(f"layer output {i}", a, b)
            for i, (a, b) in enumerate(zip(got[2], ref[2]))]
    log(f"  layer outputs: {n_enc} encoder + {cfg.n_layers} decoder "
        f"(prefill) + 8 x {cfg.n_layers} decoder (decode): max_abs_err="
        f"{max(errs[:n_enc]):.3e}, {max(errs[n_enc:n_enc + cfg.n_layers]):.3e}"
        f", {max(errs[n_enc + cfg.n_layers:]):.3e}")
    for i, (a, b) in enumerate(zip(got[3], ref[3])):
        log(f"  step {i}: logits max_abs_err={check(f'logits {i}', a, b):.3e} "
            f"tol={PARITY_TOL} ok")
    log(f"  greedy tokens GPU {got[4]}, CPU {ref[4]}: equal "
        f"{got[4] == ref[4]}; cpu {t1 - t0:.1f} s, gpu {t2 - t1:.1f} s")
    assert got[4] == ref[4]
    del params_gpu
    release(torch)


# ---------------------------------------------------------------------------
# phase 3g: the configs no other phase serves, CPU against GPU
# ---------------------------------------------------------------------------

def config_parity(torch, dev):
    """glm4-9b (a group of 16), deepseek-7b (MHA) and openpangu-7b-vl (a
    group of 7, run at width 8; its 1196-token image through the 1280 ->
    3584 projector) at full width and 2 layers in f32: a prompt prefilled
    and 4 teacher-forced decode steps, dense and paged, on the CPU (the
    port's plain versions) and on the GPU (the kernels); logits within
    PARITY_TOL, and each step launched the kernels it should."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import frontend as FE
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import make_caches

    forced = [5, 17, 42, 99]
    for arch in CONFIG_PARITY:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
        t0 = time.perf_counter()
        params_gpu = init_params(cfg,
                                 torch.Generator(device=dev).manual_seed(7),
                                 device=dev, dtype=torch.float32)
        params_cpu = map_tree(lambda t: t.cpu(), params_gpu)
        n_img = cfg.frontend.tokens_per_item if cfg.frontend else 0
        n_text, mm_pos = (40, 8) if n_img else (300, 0)
        n = n_text + n_img
        S = -(-n // 512) * 512
        text = [(7 * i + 3) % cfg.vocab for i in range(n_text)]
        toks = torch.zeros((1, S), dtype=torch.int32)
        toks[0, :mm_pos] = torch.tensor(text[:mm_pos], dtype=torch.int32)
        toks[0, mm_pos + n_img:n] = torch.tensor(text[mm_pos:],
                                                 dtype=torch.int32)
        patches = (FE.stub_embeddings(cfg, b"chip-smoke 3g", n_img)
                   if n_img else None)
        log(f"  {arch}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads of {cfg.head_dim}, vocab {cfg.vocab}, tied "
            f"{cfg.tie_embeddings}, 2 of {base.n_layers} layers; prompt "
            f"{n_text} text + {n_img} image tokens padded to {S}; params "
            f"made in {time.perf_counter() - t0:.1f} s")

        def run(params, device, layout):
            kw = {}
            if layout == "paged":
                kw = dict(layout="paged", page_size=16, n_pages=1 + S // 16)
            caches = make_caches(cfg, 1, S, dtype=torch.float32,
                                 device=device, **kw)
            if layout == "paged":
                caches["pages"][0] = torch.arange(1, 1 + S // 16,
                                                  dtype=torch.int32)
            mm = {}
            if patches is not None:
                feats = (patches.to(device) @ params["projector"]).float()
                mm = dict(mm_feats=feats[None], mm_start=mm_pos)
            logits, caches = prefill_forward(
                params, cfg, toks.to(device), caches,
                lengths=torch.tensor([n], dtype=torch.int32, device=device),
                **mm)
            out = [logits.cpu()]
            for t in forced:
                logits, caches = decode_forward(
                    params, cfg, torch.tensor([t], dtype=torch.int32,
                                              device=device), caches)
                out.append(logits.cpu())
            return out

        for layout in ("dense", "paged"):
            t0 = time.perf_counter()
            ref = run(params_cpu, "cpu", layout)
            t1 = time.perf_counter()
            ops.reset_launch_counts()
            got = run(params_gpu, dev, layout)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            wrapper = ("paged_decode_attention" if layout == "paged"
                       else "decode_attention")
            assert counts["flash_attention"] == cfg.n_layers, counts
            assert counts[wrapper] == len(forced) * cfg.n_layers, counts
            for i, (a, b) in enumerate(zip(got, ref)):
                err = (a - b).abs().max().item()
                ok = torch.allclose(a, b, **PARITY_TOL)
                log(f"  {arch} {layout} step {i}: logits max_abs_err="
                    f"{err:.3e} (max |logit| {b.abs().max().item():.3e}) "
                    f"tol={PARITY_TOL} {'ok' if ok else 'FAIL'}")
                assert ok and torch.isfinite(a).all(), (arch, layout, i, err)
            log(f"  {arch} {layout}: cpu {t1 - t0:.1f} s, gpu "
                f"{time.perf_counter() - t1:.1f} s; launches {counts}")
        del params_gpu, params_cpu
        release(torch)


# ---------------------------------------------------------------------------
# phases 3s, 3d: the dry-run's case builders on the card, and on meta
# ---------------------------------------------------------------------------

def _same(torch, what, got, want) -> None:
    """Every tensor of two trees of the same structure bitwise equal."""
    from repro_torch.models.params import flatten
    a, b = flatten(got), flatten(want)
    assert len(a) == len(b), (what, len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert (x is None) == (y is None), (what, i)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), (what, i)


def _fits(case_args, args) -> None:
    """The concrete arguments have the case's abstract shapes and dtypes."""
    from repro_torch.models.params import flatten
    want = [(t.shape, t.dtype) for t in flatten(case_args) if t is not None]
    got = [(t.shape, t.dtype) for t in flatten(args) if t is not None]
    assert got == want, (got[:4], want[:4])


def case_parity(torch, dev):
    """Phase 3s: ``launch/specs.build_case``'s steps on real bf16 tensors
    (seed 0) under ``tp_rules`` with the 1x1 local mesh's axis sizes, each
    output bitwise equal to the same entry point called directly with no
    rules active (the annotations are no-ops in one process): glm4-9b at
    full width and 2 layers (prefill 2 x 2048, then decode over the
    caches it filled, the decode kernel at its group of 16), smollm-135m
    at full size (the train case at 4 x 2048, n_micro and loss_chunk from
    ``train_plan``), mixtral-8x7b at full width and 2 layers (prefill
    1 x 4608 under expert_parallel rules, mesh None) and mamba2-370m at
    full size (prefill 1 x 2048). The launch counts are set to 0 just
    before each case's step and read just after. Returns
    {case: {"s": seconds, "launches": {...}}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_case, train_plan
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.params import init_params
    from repro_torch.models.partitioning import current_rules, tp_rules
    from repro_torch.models.transformer import clone_caches, make_caches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import make_train_step

    sizes = make_local_mesh().axis_sizes
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def model(arch, layers=None):
        base = get_config(arch)
        cfg = (dataclasses.replace(base, n_layers=layers,
                                   name=f"{base.name}-{layers}layer")
               if layers else base)
        return cfg, init_params(cfg, gen, device=dev, dtype=bf16)

    def tokens(cfg, shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def direct(name, fn):
        """The entry point without rules, timed (the same work, warm)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn()
        torch.cuda.synchronize()
        out[name]["direct_s"] = time.perf_counter() - t0
        return want

    def step(name, case, args, expect):
        """Run the case's step, timed and counted; return its outputs."""
        _fits(case.args, args)
        assert current_rules() is None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = case.fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        for wrapper in expect:
            assert counts[wrapper] > 0, (name, counts)
        out[name] = {"s": secs, "launches": counts}
        log(f"  {name}: {secs:.3f} s; launches flash "
            f"{counts['flash_attention']}, flash_bwd "
            f"{counts['flash_attention_bwd']}, decode "
            f"{counts['decode_attention']}, ssd_scan {counts['ssd_scan']}")
        return got

    def prefill(name, cfg, params, b, s, lengths, rules, expect):
        case = build_case(cfg, InputShape(name, s, b, "prefill"), rules)
        toks = tokens(cfg, (b, s))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        caches = make_caches(cfg, b, s, dtype=bf16, device=dev)
        mine = clone_caches(caches)
        got = step(name, case, (params, toks, lens, mine, None, None), expect)
        want = direct(name, lambda: prefill_forward(params, cfg, toks, caches,
                                                    lengths=lens))
        _same(torch, name, got, want)
        log(f"  {name}: logits and caches bitwise equal to prefill_forward "
            f"without rules ({out[name]['direct_s']:.3f} s)")
        return got

    # glm4-9b, 2 layers: prefill, then decode over the caches it filled
    cfg, params = model("glm4-9b", 2)
    rules = tp_rules(axis_sizes=sizes)
    logits, caches = prefill("glm4-9b prefill 2x2048", cfg, params, 2, 2048,
                             [2047, 1500], rules, ("flash_attention",))
    case = build_case(cfg, InputShape("decode", 2048, 2, "decode"), rules)
    nxt = logits.argmax(-1).to(torch.int32)
    mine = clone_caches(caches)
    got = step("glm4-9b decode 2 (group 16)", case, (params, nxt, mine),
               ("decode_attention",))
    dec = clone_caches(caches)
    want = direct("glm4-9b decode 2 (group 16)",
                  lambda: decode_forward(params, cfg, nxt, dec))
    _same(torch, "glm4 decode", got, want)
    log(f"  glm4-9b decode: logits and caches bitwise equal to "
        f"decode_forward without rules "
        f"({out['glm4-9b decode 2 (group 16)']['direct_s']:.3f} s)")
    del params, caches, mine, got, want
    release(torch)

    # smollm-135m, full size: the train case
    cfg, params = model("smollm-135m")
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    n_micro, loss_chunk = train_plan(rules, shape)
    case = build_case(cfg, shape, rules)
    opt = AdamW()
    state = opt.init(params)
    batch = {k: tokens(cfg, (TRAIN_BATCH, TRAIN_SEQ))
             for k in ("tokens", "labels")}
    name = (f"smollm-135m train {TRAIN_BATCH}x{TRAIN_SEQ} (n_micro "
            f"{n_micro}, loss_chunk {loss_chunk})")
    got = step(name, case, (params, state, batch),
               ("flash_attention", "flash_attention_bwd"))
    plain = make_train_step(cfg, opt, remat=True, num_microbatches=n_micro,
                            loss_chunk=loss_chunk)
    want = direct(name, lambda: plain(params, state, batch))
    _same(torch, "smollm train", got, want)
    log(f"  smollm-135m train: params, AdamW state and metrics bitwise equal "
        f"to make_train_step without rules ({out[name]['direct_s']:.3f} s, "
        f"the same step warm); loss {float(got[2]['loss']):.4f}")
    del params, state, got, want
    release(torch)

    # mixtral-8x7b, 2 layers, expert_parallel rules (mesh None: SPMD mode)
    cfg, params = model("mixtral-8x7b", 2)
    prefill(f"mixtral-8x7b prefill 1x{MOE_PARITY_LEN} (expert_parallel)",
            cfg, params, 1, MOE_PARITY_LEN, [MOE_PROMPT],
            tp_rules(axis_sizes=sizes, expert_parallel=True),
            ("flash_attention",))
    del params
    release(torch)

    # mamba2-370m, full size
    cfg, params = model("mamba2-370m")
    prefill(f"mamba2-370m prefill 1x{SSM_MAX_LEN}", cfg, params, 1,
            SSM_MAX_LEN, [1900], rules, ("ssd_scan",))
    del params
    release(torch)
    return out


def meta_dryrun(smi):
    """Phase 3d: the dry-run on the meta device (no card, nothing
    allocated) of one case of each family on the 16x16 mesh, through
    ``launch/dryrun.run_case``: per-device argument GiB, the analytic
    compute and memory terms at H100 SXM constants, the bottleneck and
    the seconds of each case. The whole sweep runs from the command line
    (``python -m repro_torch.launch.dryrun --all --both-meshes``)."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape, kw in DRYRUN_CASES:
        t0 = time.perf_counter()
        res = dryrun.run_case(arch, shape, rules_kw=dict(kw), save=False)
        secs = time.perf_counter() - t0
        r = res["roofline"]
        assert res["outputs_match_donated"], res
        coll = (f"null ({res['collective_reason']})"
                if r["collective_s"] is None else
                f"{r['collective_s'] * 1e3:.3f} ms for rank 0's "
                f"{res['collective_bytes']} bytes at NVLink's "
                f"{dryrun.NVLINK_BW / 1e9:.0f} GB/s")
        log(f"  {arch} x {shape} x 16x16 {kw or 'baseline'}: {secs:.1f} s; "
            f"args {res['memory']['argument_bytes'] / 2 ** 30:.2f} GiB/dev; "
            f"analytic compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms (H100 SXM constants, "
            f"{dryrun.PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
            f"{dryrun.HBM_BW / 1e12:.2f} TB/s; this card: {smi}); "
            f"collective {coll}; bound {r['bottleneck']}")
        out[f"{arch} {shape}"] = dict(res, s=secs)
    return out


# ---------------------------------------------------------------------------
# phase 3e: the expert-parallel branch across ranks
# ---------------------------------------------------------------------------

def _greedy(torch, label, got, want) -> int:
    """Hold each row's greedy token of ``got`` to ``want``'s (f32 logits
    of bf16 runs): equal, or a near-tie of ``want``: ``got``'s token
    within TIE_ULPS bf16 ulps of ``want``'s top logit (reported, with the
    tokens of ``want`` that lie within that gap of its top: 2 where two
    tie, more where several do, as random weights give a flat
    distribution over a large vocabulary). Returns the rows where they
    part."""
    parted = 0
    for row, (a, b) in enumerate(zip(got.argmax(-1).tolist(),
                                     want.argmax(-1).tolist())):
        if a == b:
            continue
        top = want[row, b].item()
        gap = top - want[row, a].item()
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        tied = int((want[row] >= want[row, a]).sum())
        ok = gap <= TIE_ULPS * ulp
        log(f"    {label} row {row}: greedy {a} against {b}, gap "
            f"{gap / ulp:.2f} bf16 ulps (at most {TIE_ULPS}), {tied} tokens "
            f"within it: {'a bf16 tie' if ok else 'FAIL'}")
        assert ok, (label, row, a, b, gap, ulp)
        parted += 1
    return parted


def _gathered_bytes(cfg, b, s) -> int:
    """The closed form of a step's all-gather bytes on a rank: the
    expert outputs (B, E, C, d) in bf16, once a MoE layer."""
    from repro_torch.models.moe import capacity
    n_moe = sum(sp.ffn == "moe" for sp in cfg.pattern) * cfg.n_repeats
    return n_moe * b * cfg.moe.n_experts * capacity(cfg, s) * \
        cfg.d_model * 2


def expert_parallel_ranks(torch, dev, smi):
    """Phase 3e: the explicit expert-parallel branch of ``moe_block``
    across two ranks (a process mesh of 1 x 2, ``launch/ranks.py``),
    each holding 4 of mixtral-8x7b's 8 experts: NCCL with one card a rank
    where the cards suffice, else both ranks on this card over gloo. The
    single-process run of the same plan and parameters goes first, its
    outputs kept on the host and its card memory freed before the ranks
    start. Held on every rank: the case builders' prefill at 1 x
    MOE_PARITY_LEN and a decode step over its caches (full width,
    MOE_LAYERS layers, bf16, seed 0; serving rules; every step timed
    warm, after a run on copies of what it writes): logits and caches
    within TOL["bfloat16"], greedy tokens equal up to a reported bf16
    tie, flash and decode launches, the all-gather bytes of the closed
    form; then a train step at 1 x 2 (fsdp rules, full width, 1 layer):
    loss and aux, the per-leaf sums of squares of the new parameters and
    AdamW state against the single-process step's blocks, flash and its
    gradient launched, the squared norm all-reduced. Where 4 cards exist,
    all 32 layers at ep = 4 over NCCL too (no single-process reference:
    93.4 GB do not fit a card; the ranks, holding the same rows, must
    agree bitwise)."""
    import shutil

    from repro_torch.launch import ranks as R
    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.models.moe import capacity
    from repro_torch.models.params import flatten

    n_cards = torch.cuda.device_count()
    desc = MeshDesc(EP_MESH, ("data", "model"))
    backend = "nccl" if n_cards >= desc.size else "gloo"
    serve = R.Plan("mixtral-8x7b", reduced=False, layers=MOE_LAYERS,
                   dtype="bfloat16",
                   prefill=(1, MOE_PARITY_LEN, (MOE_PROMPT,)), decode=True,
                   warm=True)
    train = R.Plan("mixtral-8x7b", reduced=False, layers=EP_TRAIN_LAYERS,
                   dtype="bfloat16", fsdp=True, train=EP_TRAIN, digest=True,
                   warm=True)
    cfg = R.plan_config(serve)
    tol = TOL["bfloat16"]
    out = {"backend": backend, "cards": n_cards}

    # -- the single-process reference ----------------------------------------
    t0 = time.perf_counter()
    ref = R.run_plan(serve, desc, dev)
    ref = {k: dict(ref[k], out=R.to_cpu(ref[k]["out"]))
           for k in ("prefill", "decode")}
    out["reference_s"] = time.perf_counter() - t0
    release(torch)
    cfg_t = R.plan_config(train)
    rules_t = R.plan_rules(train, desc, desc)
    t0 = time.perf_counter()
    ref_t = R.run_plan(dataclasses.replace(train, digest=False), desc,
                       dev)["train"]
    params, state, metrics = ref_t["out"]
    want_t = []
    for r in range(desc.size):
        mine = R.rank_block(cfg_t, ("params", "opt"), (None, None),
                            (params, state), rules_t,
                            R.coordinates(desc, r))
        want_t.append((R.digest(mine[0]), R.digest(mine[1])))
        del mine
    metrics = R.to_cpu(metrics)
    out["reference_train_s"] = time.perf_counter() - t0
    log(f"  single process: prefill {ref['prefill']['s']:.3f} s, decode "
        f"{ref['decode']['s']:.3f} s ({MOE_LAYERS} layers, "
        f"{cfg.moe.n_experts} experts); "
        f"train {ref_t['s']:.3f} s ({EP_TRAIN_LAYERS} layer); launches "
        f"{ref['prefill']['launches']['flash_attention']} flash, "
        f"{ref['decode']['launches']['decode_attention']} decode")
    del ref_t, params, state
    release(torch)

    # -- the ranks -----------------------------------------------------------
    run_dir = ROOT / "build" / "ranks_3e"
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    got = R.run_ranks(desc, [("plan", dict(plan=serve)),
                             ("plan", dict(plan=train))],
                      backend=backend, device="cuda", run_dir=run_dir,
                      timeout=RANKS_TIMEOUT)
    out["ranks_s"] = time.perf_counter() - t0
    b, s = 1, MOE_PARITY_LEN
    bytes_want = {"prefill": _gathered_bytes(cfg, b, s),
                  "decode": _gathered_bytes(cfg, b, 1)}
    for r, (res, res_t) in enumerate(got):
        for kind in ("prefill", "decode"):
            logits, caches = res[kind]["out"]
            w_logits, w_caches = ref[kind]["out"]
            err = (logits - w_logits).abs().max().item()
            assert torch.isfinite(logits).all() and torch.allclose(
                logits, w_logits, **tol), (r, kind, err)
            c_err, c_same = 0.0, True
            for a, w in zip(flatten(caches), flatten(w_caches)):
                if a is None:
                    continue
                assert a.shape == w.shape and a.dtype == w.dtype
                c_same &= torch.equal(a, w)
                if a.is_floating_point():
                    c_err = max(c_err, (a.float() - w.float()).abs().max()
                                .item())
                    assert torch.allclose(a.float(), w.float(), **tol)
                else:
                    assert torch.equal(a, w), (r, kind)
            parted = _greedy(torch, f"rank {r} {kind}", logits, w_logits)
            n = res[kind]["launches"]
            wrapper = ("flash_attention" if kind == "prefill"
                       else "decode_attention")
            assert n[wrapper] > 0, (r, kind, n)
            coll = res[kind]["collectives"]
            assert coll == {"all-gather": bytes_want[kind]}, (
                r, kind, coll, bytes_want[kind])
            log(f"  rank {r} {kind}: {res[kind]['s']:.3f} s; logits "
                f"max_abs_err {err:.3e} (bitwise "
                f"{torch.equal(logits, w_logits)}), caches max_abs_err "
                f"{c_err:.3e} (bitwise {c_same}), greedy parted {parted}; "
                f"{n[wrapper]} {wrapper}; all-gather "
                f"{coll['all-gather']} bytes = closed form "
                f"{MOE_LAYERS} x {b} x {cfg.moe.n_experts} x "
                f"{capacity(cfg, s if kind == 'prefill' else 1)} x "
                f"{cfg.d_model} x 2 over {res[kind]['calls']['all-gather']}"
                f" calls")
        p_dig, s_dig, m = res_t["train"]["out"]
        w_p, w_s = want_t[r]
        for what, a, w in (("params", p_dig, w_p), ("AdamW", s_dig, w_s)):
            rel = ((a[:, 1] - w[:, 1]).abs()
                   / w[:, 1].abs().clamp(min=1e-30)).max().item()
            assert rel <= EP_DIGEST_RTOL, (r, what, rel)
            log(f"  rank {r} train: {what} sums of squares, {a.shape[0]} "
                f"leaves, max relative difference {rel:.3e}")
        for k in ("loss", "aux"):
            assert torch.allclose(m[k], metrics[k], **tol), (k, m[k],
                                                             metrics[k])
        n = res_t["train"]["launches"]
        coll = res_t["train"]["collectives"]
        assert n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0, n
        assert coll.get("all-reduce") == 4, coll
        log(f"  rank {r} train {EP_TRAIN[0]}x{EP_TRAIN[1]}: "
            f"{res_t['train']['s']:.3f} s; loss {float(m['loss']):.5f} "
            f"(one process {float(metrics['loss']):.5f}), aux "
            f"{float(m['aux']):.5f} ({float(metrics['aux']):.5f}); "
            f"{n['flash_attention']} flash, {n['flash_attention_bwd']} "
            f"flash_bwd; collectives {coll}")
    out["ranks"] = [{k: {"s": v["s"], "collectives": v["collectives"]}
                     for k, v in (("prefill", res["prefill"]),
                                  ("decode", res["decode"]),
                                  ("train", res_t["train"]))}
                    for res, res_t in got]
    log(f"  [3e] backend {backend} ({n_cards} card(s)): ranks "
        f"{out['ranks_s']:.1f} s (spawn, parameters, steps); the single "
        f"process {out['reference_s']:.1f} + {out['reference_train_s']:.1f}"
        f" s; on {smi}")
    del got, ref
    release(torch)

    # -- all 32 layers at ep = 4, where 4 cards exist ------------------------
    if n_cards < 4:
        log(f"  [3e] full depth at ep = 4 over NCCL did not run: "
            f"{n_cards} card(s), 4 needed")
        return out
    full = R.Plan("mixtral-8x7b", reduced=False, dtype="bfloat16",
                  prefill=(1, MOE_PARITY_LEN, (MOE_PROMPT,)), decode=True,
                  digest=True, warm=True)
    cfg = R.plan_config(full)
    desc4 = MeshDesc((1, 4), ("data", "model"))
    run_dir = ROOT / "build" / "ranks_3e_full"
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    got = R.run_ranks(desc4, [("plan", dict(plan=full))], backend="nccl",
                      device="cuda", run_dir=run_dir,
                      timeout=RANKS_TIMEOUT)
    out["full_s"] = time.perf_counter() - t0
    first = got[0][0]
    for r, (res,) in enumerate(got):
        for kind, seq in (("prefill", s), ("decode", 1)):
            logits, dig = res[kind]["out"]
            assert torch.isfinite(logits).all(), (r, kind)
            assert torch.equal(logits, first[kind]["out"][0]), (r, kind)
            assert torch.equal(dig, first[kind]["out"][1]), (r, kind)
            wrapper = ("flash_attention" if kind == "prefill"
                       else "decode_attention")
            assert res[kind]["launches"][wrapper] > 0
            assert res[kind]["collectives"] == {
                "all-gather": _gathered_bytes(cfg, 1, seq)}, (r, kind)
            log(f"  full depth, rank {r} {kind}: {res[kind]['s']:.3f} s; "
                f"{res[kind]['launches'][wrapper]} {wrapper}; all-gather "
                f"{res[kind]['collectives']['all-gather']} bytes (closed "
                f"form); logits and cache sums bitwise rank 0's; greedy "
                f"{logits.argmax(-1).tolist()}")
    log(f"  [3e] full depth: {cfg.n_layers} layers, "
        f"{cfg.moe.n_experts // desc4.size} of {cfg.moe.n_experts} experts "
        f"a rank, NCCL over {desc4.size} cards: {out['full_s']:.1f} s; on "
        f"{smi}")
    release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 3t: tensor parallelism across ranks
# ---------------------------------------------------------------------------

def _n_layers(cfg, mixers=None, ffn=None) -> int:
    """Layers of the decoder with one of ``mixers`` (or with ``ffn``)."""
    return cfg.n_repeats * sum(
        (mixers is None or sp.mixer in mixers) and (ffn is None or
                                                   sp.ffn == ffn)
        for sp in cfg.pattern)


def _tp_bytes(cfg, mesh, b, s, text, combine) -> dict:
    """The closed form of the collective result bytes a rank moves in one
    step under the baseline rules at ``mesh`` (data, model), activations
    in bf16: ``b`` rows in all, ``s`` tokens a row in the decoder, ``text``
    of them looked up in the embedding. All-reduces (bf16): the embedding
    where 'model' divides the vocabulary (one rank's row, exact), and
    attention's and the MLP's wo where it divides q_dim and d_ff (the
    partial products, as the reference sums them), a MoE layer's expert
    buffers (rows, E, C, d) where it divides 'ff', an SSM layer's w_out
    partial products; all-gathers (bf16): q's and k/v's columns where the
    columns are cut and the heads are not, an SSM layer's fused
    activation (rows, s, 2 inner + 2 N + heads), conv weights and bias
    and conv tail (rows, W - 1, inner + 2 N); an SSM layer's out_norm
    sums of squares (rows, s) all-reduced in f32; ``combine`` (a decode
    step over a dense cache cut over its sequence): q's heads gathered
    where they are cut, and the f32 log-sum-exp maxima and weighted
    outputs all-reduced."""
    from repro_torch.models.moe import capacity
    m = mesh[1]
    rows = b // mesh[0]
    tokens = rows * s
    d, hd = cfg.d_model, cfg.head_dim
    n = _n_layers(cfg, ("attn", "swa"))
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    ar = ag = 0
    if cfg.vocab % m == 0:
        ar += rows * text * d * 2
    if n and nq * hd % m == 0:
        ar += n * tokens * d * 2
    if cfg.d_ff and cfg.d_ff % m == 0:
        ar += _n_layers(cfg, ffn="mlp") * tokens * d * 2
        if cfg.moe is not None:
            ar += _n_layers(cfg, ffn="moe") * rows * cfg.moe.n_experts * \
                capacity(cfg, s) * d * 2
    if n and nq * hd % m == 0 and nq % m:
        ag += n * tokens * nq * hd * 2
    if n and nkv * hd % m == 0 and nkv % m:
        ag += 2 * n * tokens * nkv * hd * 2
    if combine:
        if nq % m == 0:
            ag += n * rows * nq * hd * 2
        ar += n * rows * nq * (hd + 2) * 4
    n_ssm = _n_layers(cfg, ("ssm",))
    if n_ssm:
        ssm = cfg.ssm
        inner, N, W = ssm.inner_dim(d), ssm.state_dim, ssm.conv_width
        fused, conv = 2 * inner + 2 * N + ssm.n_heads(d), inner + 2 * N
        ag += n_ssm * (tokens * fused + W * conv + conv
                       + rows * (W - 1) * conv) * 2
        ar += n_ssm * (tokens * 4 + tokens * d * 2)
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


def _anchored(torch, got, want, truth):
    """Held to the f32 run: ``got``'s distance from ``truth`` over all the
    floating tensors of the trees (its largest and its mean) against
    ``want``'s, within TP_MAX_RATIO and TP_MEAN_RATIO; integer tensors
    equal. Returns (max |got - want|, elements outside the bf16 rule
    against ``want``, the same count for ``want`` against ``truth``, the
    max and mean ratios)."""
    from repro_torch.models.params import flatten
    err, outside, outside_want, n = 0.0, 0, 0, 0
    top = [0.0, 0.0]          # largest distance from truth: got, want
    total = [0.0, 0.0]        # summed distance from truth: got, want
    for a, w, t in zip(flatten(got), flatten(want), flatten(truth)):
        if a is None:
            continue
        assert a.shape == w.shape == t.shape and a.dtype == w.dtype
        if not a.is_floating_point():
            assert torch.equal(a, w) and torch.equal(a, t)
            continue
        a, w, t = a.float(), w.float(), t.float()
        err = max(err, (a - w).abs().max().item())
        outside += int((~torch.isclose(a, w, **TOL["bfloat16"])).sum())
        outside_want += int((~torch.isclose(w, t, **TOL["bfloat16"])).sum())
        for i, x in enumerate((a, w)):
            d = (x - t).abs()
            top[i] = max(top[i], d.max().item())
            total[i] += d.double().sum().item()
        n += a.numel()
    r_max = top[0] / top[1] if top[1] else float(top[0] > 0) + 1.0
    r_mean = total[0] / total[1] if total[1] else float(total[0] > 0) + 1.0
    assert top[0] <= TP_MAX_RATIO * top[1], (top, n)
    assert total[0] <= TP_MEAN_RATIO * total[1], (total, n)
    return err, outside, outside_want, r_max, r_mean


def _tp_run(torch, dev, arch, mesh, backend, layers, anchored) -> dict:
    """One model at one mesh for phase 3t (``layers``: its depth, None for
    all). ``anchored``: the single-process plan in bf16 and in f32 first
    (their outputs kept on the host, their card memory freed, one at a
    time), then the ranks in bf16. Each rank's logits block, and apart
    from it its cache blocks, are held to the f32 run no farther than one
    process's bf16 blocks are (``_anchored``): two bf16 runs whose sums
    are ordered otherwise part by as much as either does from f32, beyond
    the bf16 rule at tens of thousands of logits (``PERF.md`` §6). The
    greedy tokens equal one process's up to a reported bf16 tie. With MoE
    layers each step's routing is kept (``Plan.routes``) and a batch row
    is held so only where every token of it, in this step and the ones
    before, went to the experts that one process sent it to: a token
    routed elsewhere in one bf16 run moves its row several times as far
    as the sums' order does (``_routing_parted``, printed); the MoE runs'
    ranks are also run in f32 and held to the f32 process within
    TP_F32_SCALE of each tensor's scale, every row (``_tp_f32``). Without
    a single process (a model no one process holds): the ranks' blocks
    put together (blocks that ranks share bitwise equal), finite, each rank's greedy tokens
    (taken from its gathered logits) equal to the others' and to the
    argmax of the blocks put together. Either way one flash a prefill
    and one decode kernel a decode step (flash over a sequence-cut
    cache) for each attention layer, one ``ssd_scan`` a prefill for each
    SSM layer, and the collective bytes of the closed form. Returns the
    seconds and counts."""
    import shutil

    from repro_torch.launch import ranks as R
    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.models.partitioning import kv_heads_cut
    from repro_torch.models.transformer import cache_pspecs, make_caches

    desc = MeshDesc(mesh, ("data", "model"))
    plan = R.Plan(arch, reduced=False, layers=layers, dtype="bfloat16",
                  expert_parallel=False, prefill=TP_PREFILL, decode=1,
                  warm=True)
    cfg = R.plan_config(plan)
    moe = anchored and cfg.moe is not None
    plan = dataclasses.replace(plan, routes=moe)
    ranked = dataclasses.replace(plan, trace=(arch, mesh) in TP_TRACED)
    b, s, _ = TP_PREFILL
    n_mm = (min(cfg.frontend.tokens_per_item, s // 2)
            if cfg.frontend is not None else 0)
    tag = f"{cfg.name} at {mesh[0]} x {mesh[1]}"
    out = {"backend": backend, "layers": cfg.n_layers, "anchored": anchored}

    def single(p):
        res = R.run_plan(p, desc, dev)
        res = {k: R.to_cpu(res[k]) for k in ("prefill", "decode")}
        release(torch)
        return res

    t0 = time.perf_counter()
    if anchored:
        one = single(plan)
        f32 = single(dataclasses.replace(plan, dtype="float32", warm=False))
    out["one_process_s"] = time.perf_counter() - t0
    run_dir = ROOT / "build" / f"ranks_3t_{mesh[0]}x{mesh[1]}"
    shutil.rmtree(run_dir, ignore_errors=True)

    def ranks(p):
        res = [g[0] for g in R.run_ranks(desc, [("plan", dict(plan=p))],
                                         backend=backend, device="cuda",
                                         run_dir=run_dir,
                                         timeout=RANKS_TIMEOUT)]
        shutil.rmtree(run_dir, ignore_errors=True)
        return res

    t0 = time.perf_counter()
    got = ranks(ranked)
    out["ranks_s"] = time.perf_counter() - t0

    rules = R.block_rules(plan, desc)
    specs = (rules.spec(("batch", "act_vocab")), cache_pspecs(cfg, rules))
    if moe:
        # the same ranks in f32, held to the f32 process: the order of
        # the sums is the one difference
        for kind, err in _tp_f32(torch, cfg, desc, rules, specs, ranks(
                dataclasses.replace(plan, dtype="float32", warm=False)),
                f32, tag).items():
            out.setdefault(kind, {})["f32_scaled_err"] = err
    n_attn = _n_layers(cfg, ("attn", "swa"))
    heads_cut = kv_heads_cut(rules, cfg.n_kv_heads)
    decoder = "decode_attention" if heads_cut else "flash_attention"
    for kind, seq, text, kernels in (
            ("prefill", s, s - n_mm,
             {"flash_attention": n_attn,
              "ssd_scan": _n_layers(cfg, ("ssm",))}),
            ("decode", 1, 1, {decoder: n_attn})):
        kernels = {k: v for k, v in kernels.items() if v}
        bytes_want = _tp_bytes(cfg, mesh, b, seq, text,
                               combine=kind == "decode" and not heads_cut)
        if anchored:
            want, truth = one[kind]["out"], f32[kind]["out"]
            routed = _routing_parted(torch, desc, got, one, kind)
        else:
            want = (torch.empty((b, cfg.vocab), device="meta"),
                    make_caches(cfg, b, s, dtype=torch.bfloat16,
                                device="meta"))
        for r, res in enumerate(got):
            logits, caches = res[kind]["out"]
            assert torch.isfinite(logits).all(), (tag, r, kind)
            n = res[kind]["launches"]
            assert all(n[k] == v for k, v in kernels.items()), (
                tag, r, kind, n, kernels)
            coll = res[kind]["collectives"]
            assert coll == bytes_want, (tag, r, kind, coll, bytes_want)
            launched = ", ".join(f"{n[k]} {k}" for k in kernels)
            held = (f"{launched or 'no kernel'}; collectives {coll} = "
                    f"closed form, over {res[kind]['calls']} calls")
            if not anchored:
                log(f"  {tag}, rank {r} {kind}: {res[kind]['s']:.4f} s; "
                    f"{held}")
                continue
            coords = R.coordinates(desc, r)
            mine, exact = (R.rank_block(cfg, ("batch", "batch"), specs, t,
                                        rules, coords) for t in (want, truth))
            keep = [i for i, n_routed in enumerate(routed[r]) if not n_routed]
            routing = (f"; tokens routed elsewhere than one process (this "
                       f"step and those before) a row: {routed[r]}"
                       if moe else "")
            if not keep:
                log(f"  {tag}, rank {r} {kind}: {res[kind]['s']:.4f} s (one "
                    f"process {one[kind]['s']:.4f} s); no row held to one "
                    f"process{routing}; {held}")
                continue
            lg = _anchored(torch, *(_rows_of(torch, t, keep, 0)
                                    for t in (logits, mine[0], exact[0])))
            ca = _anchored(torch, *(_rows_of(torch, t, keep, 1)
                                    for t in (caches, mine[1], exact[1])))
            log(f"  {tag}, rank {r} {kind}: {res[kind]['s']:.4f} s (one "
                f"process {one[kind]['s']:.4f} s); rows {keep} held"
                f"{routing}; logits block: max |rank - one process| "
                f"{lg[0]:.3e}, outside the bf16 rule {lg[1]} (one process "
                f"against f32: {lg[2]}), distance from f32 max / mean "
                f"{lg[3]:.3f} / {lg[4]:.3f} of one process's; cache block: "
                f"max {ca[0]:.3e}, outside {ca[1]} (one process {ca[2]}), "
                f"{ca[3]:.3f} / {ca[4]:.3f}; {held}")
        # the ranks' blocks put back together (blocks that ranks share
        # must be bitwise equal)
        whole = R.gather_blocks(cfg, ("batch", "batch"), specs,
                                [res[kind]["out"] for res in got], want,
                                rules, desc)
        assert torch.isfinite(whole[0]).all(), (tag, kind)
        greedy = whole[0].argmax(-1)
        rows = b // mesh[0]
        for r, res in enumerate(got):
            i = R.coordinates(desc, r)["data"]
            step = 0 if kind == "prefill" else 1
            assert torch.equal(res["greedy"][:, step],
                               greedy[i * rows:(i + 1) * rows].int()), (
                tag, r, kind)
        if anchored:
            parted = _greedy(torch, f"{tag} {kind}", whole[0], want[0])
            log(f"  {tag} {kind}: greedy {greedy.tolist()} (f32 "
                f"{truth[0].argmax(-1).tolist()}), parted from one process "
                f"at {parted} rows")
        else:
            parted = None
            log(f"  {tag} {kind}: the blocks put together are finite, the "
                f"blocks the ranks share bitwise equal; greedy "
                f"{greedy.tolist()} on every rank")
        if "trace" in got[0][kind]:
            tr = got[0][kind]["trace"]
            rest = tr["device_ms"] - tr["nccl_ms"]
            log(f"  {tag} {kind}, rank 0 traced (torch.profiler, one more "
                f"step on copies of the caches): wall {tr['wall_ms']:.3f} "
                f"ms, device {tr['device_ms']:.3f} ms in {tr['launches']} "
                f"kernel launches, of which NCCL's kernels (their waits for "
                f"the other ranks included) {tr['nccl_ms']:.3f} ms; the "
                f"other kernels {rest:.3f} ms, busy "
                f"{rest / tr['wall_ms']:.3f}")
            for ms, n, key in tr["top"]:
                log(f"    {ms:9.3f} ms {n:5d}x  {key}")
        out.setdefault(kind, {}).update(
            one_process_s=one[kind]["s"] if anchored else None,
            rank_s=[res[kind]["s"] for res in got],
            collectives=got[0][kind]["collectives"],
            launches={k: got[0][kind]["launches"][k] for k in kernels},
            parted=parted, routing_parted=routed if moe else None)
    return out


def _routing_parted(torch, desc, got, one, kind) -> list:
    """For each rank of ``got``, a count a batch row of its block: the
    tokens that it sent to other experts than one process (``one``) did,
    in step ``kind`` and the steps before it (a decode step reads the
    prefill's cache), over every MoE layer; zeros without MoE layers."""
    from repro_torch.launch import ranks as R
    out = []
    for r, res in enumerate(got):
        rows = res[kind]["out"][0].shape[0]
        d = R.coordinates(desc, r)["data"]
        n = torch.zeros(rows, dtype=torch.int64)
        for k in ("prefill",) if kind == "prefill" else ("prefill", kind):
            if "routes" in res[k]:
                want = one[k]["routes"][:, d * rows:(d + 1) * rows]
                n += (res[k]["routes"] != want).any(-1).sum(dim=(0, 2))
        out.append(n.tolist())
    return out


def _rows_of(torch, tree, rows, dim) -> list:
    """The tensors of ``tree`` (in ``flatten``'s order) at the batch rows
    ``rows`` of their dimension ``dim`` (the logits' 0, the caches' 1,
    after the layers), a 1-D tensor (the caches' "len") of its one."""
    from repro_torch.models.params import flatten
    idx = torch.tensor(rows)
    return [t.index_select(0 if t.dim() == 1 else dim, idx)
            for t in flatten(tree) if t is not None]


def _tp_f32(torch, cfg, desc, rules, specs, got, f32, tag) -> dict:
    """The ranks of an f32 plan held to the f32 process of the same plan:
    their blocks put together (blocks that ranks share bitwise equal),
    each floating tensor of each step's logits and caches within
    TP_F32_SCALE of its largest magnitude, greedy tokens equal up to a
    reported tie. Returns each step's largest difference over its
    tensor's scale."""
    from repro_torch.launch import ranks as R
    from repro_torch.models.params import flatten
    out = {}
    for kind in ("prefill", "decode"):
        want = f32[kind]["out"]
        whole = R.gather_blocks(cfg, ("batch", "batch"), specs,
                                [res[kind]["out"] for res in got], want,
                                rules, desc)
        worst = 0.0
        for a, b in zip(flatten(whole), flatten(want)):
            if a is None:
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, (tag, kind)
            if not a.is_floating_point():
                assert torch.equal(a, b), (tag, kind)
                continue
            scale = max(b.abs().max().item(), 1.0)
            worst = max(worst, (a - b).abs().max().item() / scale)
        assert worst <= TP_F32_SCALE, (tag, kind, worst)
        parted = _greedy(torch, f"{tag} {kind} f32", whole[0], want[0])
        log(f"  {tag} {kind}, f32 ranks against the f32 process: largest "
            f"difference {worst:.3e} of its tensor's scale (at most "
            f"{TP_F32_SCALE}), greedy parted at {parted} rows")
        out[kind] = worst
    return out


def tensor_parallel_ranks(torch, dev, smi):
    """Phase 3t: the baseline rules (``tp_rules()``: Megatron-style tensor
    parallelism over 'model') run across ranks by the case builders'
    prefill (TP_PREFILL, bf16, full width, seed 0) and a decode step over
    its caches (``launch/ranks.py``), each rank holding its block of every
    leaf and cache. On one card, both ranks on the card over gloo, at
    1 x 2: glm4-9b and mamba2-370m at full size (the SSM block on each
    rank's heads), mixtral-8x7b at 8 layers (MoE-TP) and jamba-v0.1-52b
    at one 8-layer period (attention, SSM, MLP and MoE). Where 4 cards
    exist, over NCCL with a card a rank: glm4-9b at 1 x 2 and 1 x 4 (its
    2 kv heads gathered, the decode cache cut over its sequence),
    mamba2-370m at 1 x 2 (phase 2's rank row reads its launches),
    llava-next-mistral-7b (its image features through the projector) at
    1 x 4 and 2 x 2, jamba's period at 1 x 4, and mixtral-8x7b and
    jamba-v0.1-52b at full depth at 1 x 4, which no one process holds.
    Each run held as ``_tp_run`` says; each step timed warm; the decode
    step of TP_TRACED traced on every rank after its timed run
    (``ranks.trace_step``), rank 0's printed. Returns each run's
    seconds, counts and launches."""
    n_cards = torch.cuda.device_count()
    four = n_cards >= 4
    backend = "nccl" if four else "gloo"
    out = {"backend": backend, "cards": n_cards}
    for arch, mesh, layers, anchored in (TP_FOUR_CARDS if four
                                         else TP_ONE_CARD):
        t0 = time.perf_counter()
        key = f"{arch} {mesh[0]}x{mesh[1]}" + (f" {layers}L" if layers
                                               else "")
        out[key] = _tp_run(torch, dev, arch, mesh, backend, layers, anchored)
        log(f"  [3t] {key} over {backend}: {time.perf_counter() - t0:.1f} s; "
            f"on {smi}")
        release(torch)
    if not four:
        log(f"  [3t] the four-card part (NCCL: glm4-9b at 1 x 2 and 1 x 4, "
            f"mamba2-370m at 1 x 2, llava-next-mistral-7b at 1 x 4 and 2 x "
            f"2, jamba-v0.1-52b's period at 1 x 4, mixtral-8x7b and "
            f"jamba-v0.1-52b at full depth at 1 x 4) did not run: "
            f"{n_cards} card(s), 4 needed")
    return out


def _train_bytes(cfg, plan, mesh, n_micro, chunk, held) -> dict:
    """The closed form of the collective result bytes a rank moves in one
    train step of ``plan`` at ``mesh`` (data, model), remat on,
    activations and their gradients in bf16, ``n_micro`` microbatches,
    the head's cross entropy over ``chunk``-token chunks (0: whole),
    ``held`` gradient elements on the rank. Per microbatch: the
    embedding's all-reduce; a layer's q / k / v gathers and its two
    row-cut all-reduces, issued again by remat's recompute but for the
    MLP's sum (past the last tensor the backward saves); in the backward
    the block inputs' all-reduces ("f"), the sliced attention output's
    all-gather and, where the gathered K/V feed the rank's own q heads,
    their reduce-scatters; the vocab-parallel cross entropy's maxima and
    its sums (f32) and its input's all-reduce; the global count (f32)
    over the data ranks. Under the expert-parallel rules a MoE layer's
    output gathered over the expert axis (forward, recompute) and its
    input slice's gradient gathered; under MoE-TP its expert buffers
    (rows, E, C, d) all-reduced in the forward and in the recompute and
    their gradient all-reduced in the backward (``tp_enter``); either
    way its aux sums (2 E, f32) over the data ranks, forward and
    recompute. An SSM layer: its fused activation and conv weights
    gathered in the forward and the recompute, their gradients
    reduce-scattered; out_norm's f32 sums of squares (rows, seq) summed in
    both and their gradient in the backward; w_out's partial products
    summed (once where the layer ends the repeat) and its input's
    gradient ("f"). Per step: the data-parallel reduction of every
    gradient (f32 over microbatches, bf16 over one) and the clip's norm
    (f32) over the cut leaves."""
    from repro_torch.models import moe as MOE
    d_ranks, m = mesh
    b, s = plan.train[:2]
    rows = b // (d_ranks * n_micro)
    tokens, f = rows * s, 2
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    text = s - 1
    if chunk and text > chunk:
        text = -(-text // chunk) * chunk
    ar = ag = rs = 0
    n_moe = _n_layers(cfg, ffn="moe")
    if n_moe and d_ranks > 1:
        ar += n_moe * 2 * 2 * cfg.moe.n_experts * 4
    if plan.expert_parallel:
        E = cfg.moe.n_experts
        if m > 1:
            ag += layers * 3 * rows * E * MOE.capacity(cfg, s) * d * f
    elif m > 1:
        # the collective that ends a repeat (past its last saved tensor)
        # is not issued again by the recompute
        last = cfg.pattern[-1]
        ends = ("mlp" if last.ffn == "mlp" else
                last.mixer if last.ffn == "none" else None)
        n_attn = _n_layers(cfg, mixers=("attn", "swa"))
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q_heads = cfg.n_heads % m == 0
        unit = tokens * d * f
        if n_attn and q % m == 0:
            ar += n_attn * (2 if ends in ("attn", "swa") else 3) * unit
            if not q_heads:
                ag += n_attn * 3 * tokens * q * f
        if n_attn and kv % m == 0 and cfg.n_kv_heads % m:
            ag += n_attn * 2 * 2 * tokens * kv * f
            if q_heads:
                rs += n_attn * 2 * tokens * kv // m * f
        if cfg.d_ff and cfg.d_ff % m == 0:
            ar += _n_layers(cfg, ffn="mlp") * (2 if ends == "mlp" else 3) \
                * unit
            if n_moe:
                ar += n_moe * 3 * rows * cfg.moe.n_experts * \
                    MOE.capacity(cfg, s) * d * f
        n_ssm = _n_layers(cfg, mixers=("ssm",))
        if n_ssm:
            # the fused activation and the conv's weights gathered (forward,
            # recompute) and their gradients reduce-scattered; out_norm's
            # f32 sums of squares and w_out's partial products summed, and
            # in the backward the block input's and the sums' gradients
            ssm = cfg.ssm
            inner, N, W = ssm.inner_dim(d), ssm.state_dim, ssm.conv_width
            conv = inner + 2 * N
            gathered = tokens * (2 * inner + 2 * N + ssm.n_heads(d)) + \
                W * conv + conv
            ag += n_ssm * 2 * gathered * f
            rs += n_ssm * gathered // m * f
            ar += n_ssm * (2 * tokens * 4 + (1 if ends == "ssm" else 2) * unit
                           + unit + tokens * 4)
        if cfg.vocab % m == 0:
            ar += unit + rows * text * 3 * 4 + rows * text * d * f
    if d_ranks > 1:
        ar += 2 * 4
    ar, ag, rs = n_micro * ar, n_micro * ag, n_micro * rs
    if d_ranks > 1:
        ar += held * (4 if n_micro > 1 else 2)
    if m > 1:
        ar += 4
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag),
                              ("reduce-scatter", rs)) if v}


def _train_run(torch, dev, arch, mesh, backend, layers, shape,
               expert_parallel) -> dict:
    """One model at one mesh for phase 7r: TRAIN_RANK_STEPS train steps of
    the case builders' train case (``Plan.train``: ``train_plan``'s
    microbatches and loss chunk at the mesh, remat) in one process, bf16
    and f32 (their outputs kept on the host, their card memory freed),
    then on the ranks. Each rank: its loss each step bitwise equal to the
    other ranks' and within the bf16 rule of one process's; the
    ``digest``s (each leaf's sum and sum of squares) of its blocks of the
    new parameters and AdamW moments no farther from the f32 run's than
    one bf16 process's (``_anchored``; mu is 0.1 times the clipped
    gradient after the first step, so every gradient leaf is held); two
    forwards (remat's recompute) and one gradient a layer a microbatch of
    flash (attention layers) and ssd_scan (SSM layers); the collective
    bytes of ``_train_bytes``. Seconds a step
    (the first warms the second), and one more step after the last traced
    on every rank (rank 0's printed). Returns the seconds, counts and
    launches."""
    import shutil

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import ranks as R
    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.launch.specs import train_plan
    from repro_torch.models.params import abstract_params, flatten

    desc = MeshDesc(mesh, ("data", "model"))
    plan = R.Plan(arch, reduced=False, layers=layers, dtype="bfloat16",
                  expert_parallel=expert_parallel, train=shape,
                  train_steps=TRAIN_RANK_STEPS)
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    n_micro, chunk = train_plan(rules, InputShape("train", shape[1], shape[0],
                                                  "train"))
    tag = f"{cfg.name} at {mesh[0]} x {mesh[1]}"
    out = {"backend": backend, "micro": n_micro}
    roles = R.OUT_ROLES["train"][:2]

    def steps(res):
        return [res["train"]] + res["train_more"]

    def single(p):
        """Each step's loss and seconds, and the digests of each rank's
        blocks of its new parameters and AdamW state (made on the card)."""
        res = R.run_plan(p, desc, dev)
        recs = [dict(s=rec["s"], loss=float(rec["out"][2]["loss"]), blocks=[
            tuple(map(R.digest, R.rank_block(
                cfg, roles, (None, None), rec["out"][:2], rules,
                R.coordinates(desc, r)))) for r in range(desc.size)])
            for rec in steps(res)]
        del res
        release(torch)
        return recs

    t0 = time.perf_counter()
    one = single(plan)
    f32 = single(dataclasses.replace(plan, dtype="float32"))
    out["one_process_s"] = time.perf_counter() - t0
    run_dir = ROOT / "build" / f"ranks_7r_{cfg.name}_{mesh[0]}x{mesh[1]}"
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ranked = dataclasses.replace(plan, trace=True, digest=True)
    got = [steps(g[0]) for g in R.run_ranks(
        desc, [("plan", dict(plan=ranked))], backend=backend, device=dev.type,
        run_dir=run_dir, timeout=RANKS_TIMEOUT)]
    out["ranks_s"] = time.perf_counter() - t0
    shutil.rmtree(run_dir, ignore_errors=True)

    held = sum(t.numel() for t in flatten(R.rank_block(
        cfg, ("params",), (None,), (abstract_params(cfg),), rules,
        R.coordinates(desc, 0))[0]))
    want_bytes = _train_bytes(cfg, plan, mesh, n_micro, chunk, held)
    # a forward (and remat's recompute) and a gradient a layer a microbatch
    n_attn = _n_layers(cfg, mixers=("attn", "swa"))
    n_ssm = _n_layers(cfg, mixers=("ssm",))
    want_launches = {"flash_attention": 2 * n_attn * n_micro,
                     "flash_attention_bwd": n_attn * n_micro,
                     "ssd_scan": 2 * n_ssm * n_micro,
                     "ssd_scan_bwd": n_ssm * n_micro}
    out["steps"] = []
    for i, (w, t) in enumerate(zip(one, f32)):
        loss = [float(g[i]["out"][2]["loss"]) for g in got]
        want = w["loss"]
        log(f"  {tag}, step {i + 1}: loss {loss[0]:.6f} on every rank "
            f"(one process bf16 {want:.6f}, f32 {t['loss']:.6f})")
        assert all(x == loss[0] for x in loss), (tag, i, loss)
        assert math.isfinite(loss[0]) and abs(loss[0] - want) <= \
            TOL["bfloat16"]["rtol"] * abs(want), (tag, i, loss, want)
        for r, res in enumerate(got):
            a = _anchored(torch, res[i]["out"][:2], w["blocks"][r],
                          t["blocks"][r])
            n = res[i]["launches"]
            assert all(n[k] == v for k, v in want_launches.items()), (
                tag, n, want_launches)
            coll = res[i]["collectives"]
            assert coll == want_bytes, (tag, r, coll, want_bytes)
            log(f"    rank {r}: {res[i]['s']:.4f} s (one process "
                f"{w['s']:.4f} s); digests of its blocks of the new "
                f"parameters, mu, nu: max |rank - one process| {a[0]:.3e}, "
                f"outside the bf16 rule {a[1]} (one process against f32: "
                f"{a[2]}), distance from f32 max / mean {a[3]:.3f} / "
                f"{a[4]:.3f} of one process's; launches "
                f"{({k: n[k] for k in want_launches})}; collectives {coll} "
                f"= closed form, over {sum(res[i]['calls'].values())} calls")
        out["steps"].append({"one_process_s": w["s"],
                             "rank_s": [g[i]["s"] for g in got],
                             "loss": loss[0]})
    tr = got[0][0]["trace"]
    rest = tr["device_ms"] - tr["nccl_ms"]
    log(f"  {tag}, rank 0 traced (torch.profiler, one more step after "
        f"the last): wall {tr['wall_ms']:.3f} ms, device "
        f"{tr['device_ms']:.3f} ms in {tr['launches']} kernel launches, "
        f"of which NCCL's kernels "
        f"{tr['nccl_ms']:.3f} ms; the other kernels {rest:.3f} ms, busy "
        f"{rest / tr['wall_ms']:.3f}")
    for ms, n, key in tr["top"]:
        log(f"    {ms:9.3f} ms {n:5d}x  {key}")
    out["collectives"] = want_bytes
    out["launches"] = {k: got[0][0]["launches"][k] for k in want_launches}
    return out


def train_ranks(torch, dev, smi):
    """Phase 7r: the train step across ranks (``launch/ranks.py``: each
    rank its block of every leaf and AdamW moment and its rows of each
    microbatch; the data-parallel reduction, TP's transposes, the global
    loss), held on every rank to one process of the same plan
    (``_train_run``). On one card: smollm-135m at full size (30 layers),
    bf16, 7t's batch of 4 x 2048, at 2 x 1 (pure data parallel) and 1 x 2
    (q and K/V columns gathered, attention on every head on both ranks,
    'ff' and 'vocab' cut), mixtral-8x7b at full width and 1 layer at
    1 x 2 under MoE-TP (each expert's 'ff' cut over 'model') and
    mamba2-370m at full width, 16 layers, at 1 x 2 (the SSM block on each
    rank's heads, ssd_scan and its gradient kernel), both ranks on the
    card over gloo. Where 4 cards exist, over NCCL with a card a rank:
    smollm-135m at 2 x 2, glm4-9b at 1 x 4 (its 8 local q heads over one
    gathered kv head of 128, whose gradient is reduce-scattered),
    mixtral-8x7b at 2 x 2 under the expert-parallel rules and under
    MoE-TP, and mamba2-370m at full size at 2 x 2, each cut to the layers
    that one process's AdamW step holds on 80 GB (TRAIN_FOUR_CARDS)."""
    from repro_torch.configs import get_config

    n_cards = torch.cuda.device_count()
    four = n_cards >= 4
    backend = "nccl" if four else "gloo"
    out = {"backend": backend, "cards": n_cards}
    for arch, mesh, layers, shape, ep in (TRAIN_FOUR_CARDS if four
                                          else TRAIN_ONE_CARD):
        t0 = time.perf_counter()
        rules = ("expert-parallel" if ep else "MoE-TP") if \
            get_config(arch).moe is not None else "TP"
        run = out[f"{arch} {mesh[0]}x{mesh[1]} {rules}"] = _train_run(
            torch, dev, arch, mesh, backend, layers, shape, ep)
        log(f"  [7r] {arch} at {mesh[0]} x {mesh[1]} ({rules}) over "
            f"{backend}: "
            f"{time.perf_counter() - t0:.1f} s (one process, bf16 and f32: "
            f"{run['one_process_s']:.1f} s; the ranks, started to joined: "
            f"{run['ranks_s']:.1f} s); on {smi}")
        release(torch)
    if not four:
        log(f"  [7r] the four-card part (NCCL: smollm-135m at 2 x 2, "
            f"glm4-9b at 1 x 4, mixtral-8x7b at 2 x 2 expert-parallel and "
            f"MoE-TP, mamba2-370m at 2 x 2) did not run: "
            f"{n_cards} card(s), 4 needed")
    return out


# ---------------------------------------------------------------------------
# phase 3c: CUDA-graph replays against eager steps
# ---------------------------------------------------------------------------

def graph_parity(torch, dev):
    """Every call of a captured step runs eagerly on a copy of the caches
    too, and the two must agree bitwise (logits and every cache tensor,
    ``graphs.held_to_eager``); counts the comparisons in which the
    engine's call was a replay. Returns the launches of each fp8 case
    (set to 0 just before it is served, read just after; the eager
    checks' launches do not count)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import frontend as FE
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.graphs import held_to_eager
    from repro_torch.serving.request import Request
    from repro_torch.serving.steps import make_encode_fn

    replays, fp8_counts, moe_counts, censuses = {}, {}, {}, {}
    f8 = dict(kv_dtype=torch.float8_e4m3fn)
    paged = dict(paged=True, page_size=16, preemption=True)
    # (label, arch, max_len, engine options, prompt lengths, payload of
    # the first two requests: an image, audio frames or none)
    cases = [("llava dense", "llava-next-mistral-7b", MAX_LEN, {},
              (40, 20, 100, 64, 30), "image"),
             ("llava paged", "llava-next-mistral-7b", MAX_LEN, paged,
              (40, 20, 100, 64, 30), None),
             ("llava dense fp8", "llava-next-mistral-7b", MAX_LEN, f8,
              (40, 20, 100, 64, 30), "image"),
             ("llava paged fp8", "llava-next-mistral-7b", MAX_LEN,
              dict(paged, **f8), (40, 20, 100, 64, 30), None),
             ("mamba2", "mamba2-370m", SSM_MAX_LEN, {},
              (64, 256, 1000, 1900, 500), None),
             # the first request decodes past the 4096 window
             ("mixtral dense", "mixtral-8x7b", MOE_MAX_LEN, {},
              (4200, 20, 100, 64, 30), None),
             ("mixtral paged", "mixtral-8x7b", MOE_MAX_LEN, paged,
              (4200, 20, 100, 64, 30), None),
             # at its full depth; every request carries audio frames
             ("whisper dense", "whisper-base", WHISPER_MAX_LEN, {},
              (40, 20, 100, 64, 30), "audio"),
             ("whisper paged", "whisper-base", WHISPER_MAX_LEN, paged,
              (40, 20, 100, 64, 30), "audio")]
    for label, arch, max_len, opts, prompts, payload in cases:
        with held_to_eager() as counted:
            cfg = base = get_config(arch)
            if cfg.encoder is None:
                cfg = dataclasses.replace(base, n_layers=2,
                                          name=base.name + "-2layer")
            params = init_params(cfg,
                                 torch.Generator(device=dev).manual_seed(0),
                                 device=dev, dtype=torch.bfloat16)
            eng = Engine(cfg, params, max_batch=4, max_len=max_len,
                         device=dev, **opts)
            encode = make_encode_fn(cfg)
            audio = payload == "audio"
            image = payload == "image"
            reqs = [Request(prompt_tokens=[(11 * i + 5 * j + 2) % cfg.vocab
                                           for j in range(n)],
                            max_new_tokens=5 if i == 1 else 24,
                            mm_payload=(b"chip-smoke audio %d" % (i % 2)
                                        if audio else b"chip-smoke graphs"
                                        if image and i < 2 else None),
                            mm_tokens=IMAGE_TOKENS if image and i < 2 else 0,
                            mm_pos=0)
                    for i, n in enumerate(prompts)]
            queue, step = list(reqs), 0
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            while queue or eng.n_active or eng.preempted:
                while queue and eng.free_slots():
                    r = queue.pop(0)
                    kw = {}
                    if audio:
                        kw = dict(enc_frames=FE.stub_embeddings(
                            cfg, r.mm_payload)[None])
                    elif r.mm_payload is not None:
                        feats = FE.stub_embeddings(cfg, r.mm_payload,
                                                   r.mm_tokens)
                        kw = dict(mm_feats=encode(params, feats)[None],
                                  mm_key=FE.content_hash(r.mm_payload))
                    first, kv = eng.prefill_request(r, **kw)
                    eng.insert(r, kv, first)
                if eng.paged and step == 6:
                    eng.preempt_slot(eng.slots.index(reqs[0]))
                eng.decode_step()
                step += 1
            torch.cuda.synchronize()
            if "kv_dtype" in opts:
                fp8_counts[label] = ops.launch_counts()
            if arch == "mixtral-8x7b":
                moe_counts[label] = ops.launch_counts()
            assert all(len(r.output_tokens) == r.max_new_tokens
                       for r in reqs), label
            if eng.paged:
                assert eng.preempt_count == 1 and eng.resume_count == 1
                eng.assert_no_page_leaks()
            census = censuses[label] = eng.graph_census()
            log(f"  {label}: {step} decode steps, every call bitwise equal "
                f"to eager; graphs {census}")
            # serving never takes the autograd path: no gradient kernel
            # launched, none in a graph
            assert ops.launch_counts()["flash_attention_bwd"] == 0, label
            assert not any("flash_attention_bwd" in k
                           for c in census.values() if isinstance(c, dict)
                           for k in c), census
            del eng, params
            release(torch)
        replays.update({f"{label} {k}": n for k, n in counted.items()})
    log(f"  replays compared bitwise: {replays}")
    want = {"llava dense decode", "llava dense dense_prefill",
            "llava paged decode", "llava dense fp8 decode",
            "llava dense fp8 dense_prefill", "llava paged fp8 decode",
            "mamba2 decode", "mamba2 dense_prefill", "mixtral dense decode",
            "mixtral dense dense_prefill", "mixtral paged decode",
            "whisper dense decode", "whisper dense dense_prefill",
            "whisper paged decode"}
    assert set(replays) == want, replays
    # whisper's graphs: a decode step holds one self-attention decode node
    # and one cross-attention flash node a decoder layer, the dense
    # prefill one flash node an encoder layer and two a decoder layer,
    # and neither any other kernel of ours
    n = get_config("whisper-base").n_layers
    n_enc = get_config("whisper-base").encoder.n_layers
    for label, wrapper in (("whisper dense", "decode_attention"),
                           ("whisper paged", "paged_decode_attention")):
        ours = {k: v for k, v in censuses[label]["decode"].items()
                if k.endswith(" nodes")}
        assert ours == {f"{wrapper} nodes": n,
                        "flash_attention nodes": n}, (label, ours)
    ours = {k: v for k, v in censuses["whisper dense"]["prefill"].items()
            if k.endswith(" nodes")}
    assert ours == {"flash_attention nodes": 2 * n + n_enc}, ours
    log(f"  whisper graph census: decode {n} flash + {n} decode nodes, "
        f"dense prefill {2 * n + n_enc} flash nodes, as required")
    log(f"  launches of the fp8 cases: {fp8_counts}; of the mixtral cases: "
        f"{moe_counts}")
    for label, wrapper in (("mixtral dense", "decode_attention"),
                           ("mixtral paged", "paged_decode_attention")):
        assert moe_counts[label]["flash_attention"] > 0, moe_counts
        assert moe_counts[label][wrapper] > 0, moe_counts
    assert fp8_counts["llava dense fp8"]["decode_attention"] > 0
    assert fp8_counts["llava paged fp8"]["paged_decode_attention"] > 0
    return fp8_counts


# ---------------------------------------------------------------------------
# phases 4, 5, 4b: serving at full width
# ---------------------------------------------------------------------------

def instrument(torch, engine):
    """Stamp wall-clock first-token and done times on the decode engine's
    requests (both drivers insert and decode through these methods)."""
    insert, decode_step = engine.insert, engine.decode_step

    def timed_insert(req, *a, **kw):
        slot = insert(req, *a, **kw)
        torch.cuda.synchronize()
        req.t_first_token = time.perf_counter()
        return slot

    def timed_decode_step():
        out = decode_step()
        now = time.perf_counter()    # decode_step synced to read tokens
        for r, _t, done in out:
            if done:
                r.t_done = now
        return out

    engine.insert, engine.decode_step = timed_insert, timed_decode_step


def ssm_requests(cfg):
    """The four text-only requests of the mamba2 phase: prompts of
    SSM_PROMPTS tokens, 16 new tokens each."""
    from repro_torch.serving.request import Request
    return [Request(prompt_tokens=[(13 * i + 7 * j + 1) % cfg.vocab
                                   for j in range(n)], max_new_tokens=16)
            for i, n in enumerate(SSM_PROMPTS)]


def serve(torch, dev, cfg, params, mode, reqs, max_len, continuous, path,
          kv_dtype=None, hits="store", run_kw=None, probe=None, **kw):
    """Serve ``reqs`` on a fresh EPDCluster with the launch counters set
    to 0 just before and read just after; every kernel in ``path`` must
    have launched. ``kv_dtype``: the cluster's engines rebuilt to store
    K/V in it, as ``launch/serve.py --kv-fp8`` does. ``hits``: what a
    paged run must have hit at least once, the MM store ("store", an
    image shared by two requests) or the prefix cache ("prefix").
    ``run_kw``: options of ``run_continuous``. ``probe(cluster)``: run
    after the timed run, before the cluster is dropped; its result is
    the stats' "probe". The cluster models its transfer charges on the
    card's cost profile (``costmodel.H100``)."""
    from repro_torch.core.cluster import EPDCluster
    from repro_torch.core.costmodel import H100
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import with_kv_dtype

    cluster = EPDCluster(cfg, params, max_batch=4, max_len=max_len,
                         device=dev, hw=H100, **kw)
    if kv_dtype is not None:
        with_kv_dtype(cluster, kv_dtype)
    engines = [cluster.prefill_engine, *cluster.decode_engines]
    want = kv_dtype or params["embed"].dtype
    assert all(c.k.dtype == want for e in engines for c in e.caches["attn"]
               if c is not None), mode
    # the decode pool's K/V bytes (paged) or the decode cache's (dense)
    kv_bytes = sum(t.numel() * t.element_size()
                   for e in cluster.decode_engine.caches["attn"]
                   if e is not None for t in e[:2])
    for eng in cluster.decode_engines:
        instrument(torch, eng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.t_arrival = t0
    if continuous:
        done = cluster.run_continuous(reqs, **(run_kw or {}))
    else:
        for r in reqs:
            cluster.submit(r)
        done = cluster.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    graphs = cluster.graph_census()
    assert len(done) == len(reqs) and not cluster.report.lost, \
        f"{mode}: {len(done)}/{len(reqs)} completed"
    assert all(counts[k] > 0 for k in path), (mode, counts)
    assert counts["flash_attention_bwd"] == 0, (mode, counts)
    assert graphs["decode"]["replays"] > 0, f"{mode}: no decode replay"
    for r in reqs:
        assert len(r.output_tokens) == r.max_new_tokens, r.output_tokens
        assert all(0 <= t < cfg.vocab for t in r.output_tokens)
    if kw.get("paged"):
        for eng in [cluster.prefill_engine, *cluster.decode_engines]:
            eng.assert_no_page_leaks()
        assert cluster.decode_engine.pool.n_used == 0
        hit = (cluster.store.stats if hits == "store"
               else cluster.prefill_engine.prefix_cache.stats)
        assert hit.hits >= 1, (hits, hit)
    n_out = sum(len(r.output_tokens) for r in reqs)
    stats = dict(
        ttft_ms=[1e3 * r.ttft for r in reqs],
        tpot_ms=[1e3 * r.tpot for r in reqs],
        tokens_per_s=n_out / wall, wall_s=wall, n_out=n_out,
        counts=counts, graphs=graphs, kv_bytes=kv_bytes,
        store=cluster.store.stats,
        outputs=[list(r.output_tokens) for r in reqs])
    pc = cluster.prefill_engine.prefix_cache
    log(f"  {mode}: {len(done)}/{len(reqs)} completed in {wall:.2f} s; "
        f"launches {counts}; CUDA graphs {graphs}; MM store "
        f"{cluster.store.stats}; prefix cache "
        f"{pc.stats if pc is not None else None}; decode K/V {kv_bytes} "
        f"bytes")
    for r in reqs:
        log(f"    req {r.request_id} ({len(r.prompt_tokens)} text + "
            f"{r.mm_tokens} image tokens) -> {r.output_tokens}")
    if probe is not None:
        stats["probe"] = probe(cluster)
    del cluster
    release(torch)
    return stats


def glm_requests(cfg):
    """The four text requests of phases 4g and 5g (GLM_PROMPTS), 16 new
    tokens each; B's first 1536 tokens are A's."""
    from repro_torch.serving.request import Request
    a = [(13 * j + 1) % cfg.vocab for j in range(GLM_PROMPTS[0])]
    prompts = [a, a[:1536] + [(7 * j + 5) % cfg.vocab
                              for j in range(GLM_PROMPTS[1] - 1536)]]
    prompts += [[(11 * i + 3 * j + 2) % cfg.vocab for j in range(n)]
                for i, n in enumerate(GLM_PROMPTS[2:])]
    return [Request(prompt_tokens=p, max_new_tokens=16) for p in prompts]


def greedy_agreement(torch, dev, cfg, params, reqs, dense, paged):
    """Hold the dense and the paged run's greedy tokens to each other: a
    request's tokens are equal up to its first difference, if any; there
    one eager prefill of the prompt and the common tokens (a third
    computation, on a dense cache) must rank the two runs' tokens first
    and second, TIE_ULPS bf16 ulps of the top logit apart at most (a
    near-tie that bf16 rounding breaks either way). Tokens after the
    difference are not compared. Returns the number of requests whose
    tokens are all equal."""
    from repro_torch.models.model import prefill_forward
    from repro_torch.models.transformer import make_caches

    equal = 0
    for r, a, b in zip(reqs, dense, paged):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            equal += 1
            continue
        seq = list(r.prompt_tokens) + a[:i]
        S = -(-len(seq) // 512) * 512
        toks = torch.zeros((1, S), dtype=torch.int32, device=dev)
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        caches = make_caches(cfg, 1, S, dtype=params["embed"].dtype,
                             device=dev)
        logits, _ = prefill_forward(params, cfg, toks, caches,
                                    lengths=torch.tensor([len(seq)],
                                                         dtype=torch.int32,
                                                         device=dev))
        top2 = torch.topk(logits[0], 2)
        gap = abs(logits[0, a[i]] - logits[0, b[i]]).item()
        ulp = 2.0 ** (math.floor(math.log2(abs(top2.values[0].item()))) - 7)
        ok = (set(top2.indices.tolist()) == {a[i], b[i]}
              and gap <= TIE_ULPS * ulp)
        log(f"    req of {len(r.prompt_tokens)} tokens: dense and paged part "
            f"at new token {i} ({a[i]} against {b[i]}); a third forward "
            f"over the common prefix ranks {top2.indices.tolist()} first, "
            f"logits {[round(v, 4) for v in top2.values.tolist()]}, gap "
            f"{gap:.4f} = {gap / ulp:.2f} bf16 ulps (at most {TIE_ULPS}) "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, (i, a[i], b[i], gap, ulp)
        del caches
    release(torch)
    return equal


def device_time_ms(torch, fn):
    """Device time of one call of ``fn``: the sum of the times of the
    kernels it ran (a graph replay's included), as torch.profiler records
    them; gaps between kernels are not counted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    assert ms > 0, "torch.profiler recorded no device time"
    return ms


def analytic_readings(torch, cfg, reqs, smi):
    """Phase 4g's probe: the analytic model (``launch/analytic.py``)
    against device time, on the served cluster. The dense prefill: one
    more replayed prefill of the longest prompt, ``step_flops`` of an
    InputShape of its length over its device time, as a share of 989
    TFLOP/s. A decode step: the four prompts prefilled and inserted into
    the decode engine, one step, ``step_hbm_bytes`` of an InputShape of
    their mean length and batch 4 over its device time, against 3.35
    TB/s. Printed readings, not claims."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.analytic import step_flops, step_hbm_bytes
    from repro_torch.serving.request import Request

    def probe(cluster):
        pe, de = cluster.prefill_engine, cluster.decode_engine
        longest = max(reqs, key=lambda r: len(r.prompt_tokens))
        r = Request(prompt_tokens=list(longest.prompt_tokens),
                    max_new_tokens=4)
        pe.prefill_request(r)
        n = len(r.prompt_tokens)
        pre_ms = device_time_ms(torch, lambda: pe.prefill_request(r))
        flops = step_flops(cfg, InputShape("4g prefill", n, 1, "prefill"))
        share = flops / (pre_ms / 1e3) / PEAK_BF16
        fresh = [Request(prompt_tokens=list(q.prompt_tokens),
                         max_new_tokens=8) for q in reqs]
        for q in fresh:
            first, kv = pe.prefill_request(q)
            de.insert(q, kv, first)
        de.decode_step()
        ctx = [len(q.prompt_tokens) + len(q.output_tokens) for q in fresh]
        dec_ms = device_time_ms(torch, de.decode_step)
        shape = InputShape("4g decode", sum(ctx) // len(ctx), len(ctx),
                           "decode")
        nbytes = step_hbm_bytes(cfg, shape, 1)
        rate = nbytes / (dec_ms / 1e3)
        log(f"  [4g] analytic, dense prefill of {n} tokens: step_flops "
            f"{flops:.4e} over {pre_ms:.3f} ms of device time = "
            f"{flops / (pre_ms / 1e3) / 1e12:.1f} TFLOP/s, "
            f"{100 * share:.1f} % of {PEAK_BF16 / 1e12:.0f} TFLOP/s "
            f"({smi})")
        log(f"  [4g] analytic, decode step of batch {len(ctx)}, mean "
            f"context {shape.seq_len}: step_hbm_bytes {nbytes:.4e} over "
            f"{dec_ms:.3f} ms of device time = {rate / 1e12:.3f} TB/s, "
            f"{100 * rate / HBM_BPS:.1f} % of {HBM_BPS / 1e12:.2f} TB/s "
            f"({smi})")
        return dict(prefill_tokens=n, prefill_flops=flops,
                    prefill_device_ms=pre_ms, flops_share=share,
                    decode_batch=len(ctx), decode_context=shape.seq_len,
                    decode_bytes=nbytes, decode_device_ms=dec_ms,
                    hbm_share=rate / HBM_BPS)
    return probe


def ptxas_summary(text):
    """(kernel, registers, spill stores/loads, static shared bytes, mangled
    name) of each function that ``nvcc -Xptxas -v`` compiled, names
    demangled where c++filt exists."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([name, int(m.group(1)), spill,
                         int(smem.group(1)) if smem else 0, name])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout.split("\n")
        for r, d in zip(rows, out):
            r[0] = d.split(">(")[0] + ">" if ">(" in d else d
    return rows


def ssd_dynamic_smem(torch, mangled):
    """Dynamic shared memory of an ssd_scan chunk kernel from its mangled
    name (dtype, N, PB), or None for a kernel that asks for none."""
    from repro_torch.kernels.ssd_scan.kernel import smem_bytes
    m = re.search(r"(state_kernel|out_kernel)I(f|13__nv_bfloat16)Li(\d+)ELi"
                  r"(\d+)E", mangled)
    if not m:
        return None
    dtype = torch.float32 if m.group(2) == "f" else torch.bfloat16
    return smem_bytes(int(m.group(3)), int(m.group(4)), dtype)[
        m.group(1) == "out_kernel"]


def moe_requests(cfg):
    """The four text requests of phases 4m and 5m (MOE_PROMPTS), 16 new
    tokens each; B's first 2048 tokens are A's."""
    from repro_torch.serving.request import Request
    a = [(13 * j + 1) % cfg.vocab for j in range(MOE_PROMPTS[0])]
    prompts = [a, a[:2048] + [(7 * j + 5) % cfg.vocab
                              for j in range(MOE_PROMPTS[1] - 2048)]]
    prompts += [[(11 * i + 3 * j + 2) % cfg.vocab for j in range(n)]
                for i, n in enumerate(MOE_PROMPTS[2:])]
    return [Request(prompt_tokens=p, max_new_tokens=16) for p in prompts]


# ---------------------------------------------------------------------------
# phases 7, 7t: training smollm-135m
# ---------------------------------------------------------------------------

# phases 7, 7t: each model with the kernels whose forward and gradient its
# train step launches (one of each a layer without remat)
TRAIN_MODELS = {"smollm-135m": ("flash_attention", "flash_attention_bwd"),
                "mamba2-370m": ("ssd_scan", "ssd_scan_bwd")}


def train_parity(torch, dev):
    """One train step of each TRAIN_MODELS model at full width and 2 layers
    in f32, on the CPU (plain versions) and on the card (the forward
    kernel and its gradient kernel), from the same params and batch: the
    loss, every gradient leaf (as the optimizer receives it) and the
    updated params agree; on the card remat=True equals remat=False
    bitwise."""
    for arch, (fwd, bwd) in TRAIN_MODELS.items():
        log(f"  [7] {arch}")
        _train_parity(torch, dev, arch, fwd, bwd)
        release(torch)


def _train_parity(torch, dev, arch, fwd, bwd):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import flatten, init_params, map_tree
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import make_train_step

    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(synthetic_batches(cfg, *PARITY_TRAIN, 1, seed=7,
                                   device="cpu"))
    seen = []

    class Spy(AdamW):
        """AdamW that keeps the gradients it is given."""

        def update(self, grads, state, params):
            seen.append(grads)
            return super().update(grads, state, params)

    opt = Spy(lr=1e-3, warmup_steps=1)
    t0 = time.perf_counter()
    p_cpu, _, m_cpu = make_train_step(cfg, opt, remat=False)(
        params, opt.init(params), batch)
    cpu_s = time.perf_counter() - t0
    gp = map_tree(lambda t: t.to(dev), params)
    gb = {k: t.to(dev) for k, t in batch.items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    p_gpu, _, m_gpu = make_train_step(cfg, opt, remat=False)(
        gp, opt.init(gp), gb)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    p_rem, _, m_rem = make_train_step(cfg, opt, remat=True)(
        gp, opt.init(gp), gb)
    torch.cuda.synchronize()
    assert counts[fwd] == cfg.n_layers, counts
    assert counts[bwd] == cfg.n_layers, counts
    dl = abs(float(m_cpu["loss"]) - float(m_gpu["loss"]))
    log(f"  loss: CPU {float(m_cpu['loss']):.6f} ({cpu_s:.1f} s), GPU "
        f"{float(m_gpu['loss']):.6f}, |diff| {dl:.3e} (tol 1e-4); launches "
        f"{counts}")
    assert dl < 1e-4
    worst = 0.0
    names = [f"leaf {i}" for i in range(len(flatten(seen[0])))]
    for n, a, b in zip(names, flatten(seen[0]), flatten(seen[1])):
        err = (b.cpu() - a).abs().max().item()
        mag = a.abs().max().item()
        worst = max(worst, err / max(mag, 1e-30))
        log(f"    grad {n} {tuple(a.shape)}: max_abs_err {err:.3e}, max |g| "
            f"{mag:.3e}")
        assert err <= 1e-4 * mag + 1e-7, (n, err, mag)
    # Adam's first step is lr g / (|g| + 1e-8), nearly lr sign(g): where
    # |g| is tiny, a difference in g's last digits moves the update by up
    # to 2 lr. Held at 1e-5 where |g| >= 1e-6, at 2 lr elsewhere.
    perr, tiny, terr = 0.0, 0, 0.0
    for a, b, g in zip(flatten(p_cpu), flatten(p_gpu), flatten(seen[0])):
        d = (b.cpu() - a).abs()
        small = g.abs() < 1e-6
        perr = max(perr, d[~small].max().item() if (~small).any() else 0.0)
        if small.any():
            tiny += int(small.sum())
            terr = max(terr, d[small].max().item())
    log(f"  gradients: worst max_abs_err / max |g| {worst:.3e} (tol 1e-4); "
        f"updated params max_abs_err {perr:.3e} where |g| >= 1e-6 (tol "
        f"1e-5), {terr:.3e} at the {tiny} coordinates where |g| < 1e-6 "
        f"(tol 2 lr = {2 * opt.lr:.0e})")
    assert perr <= 1e-5 and terr <= 2 * opt.lr
    same = (all(torch.equal(a, b) for a, b in zip(flatten(p_gpu),
                                                   flatten(p_rem)))
            and all(torch.equal(a, b) for a, b in zip(flatten(seen[1]),
                                                       flatten(seen[2])))
            and float(m_gpu["loss"]) == float(m_rem["loss"]))
    log(f"  remat=True equals remat=False on the card, bitwise: {same}")
    assert same


def train_full(torch, dev):
    """Each TRAIN_MODELS model at full width and depth in bf16
    (``_train_full``); smollm's run then saves a checkpoint, restores it
    and takes one more step, bitwise equal to the step without the round
    trip. Returns the numbers by arch."""
    from repro_torch.models.params import flatten
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    out = {}
    for arch, kernels in TRAIN_MODELS.items():
        log(f"  [7t] {arch}")
        res, keep = _train_full(torch, dev, arch, kernels,
                                keep=arch == "smollm-135m")
        out[arch] = res
        if keep is None:
            release(torch)
            continue
        cfg, step_fn, params, state, batch = keep
        ckpt = ROOT / "build" / "chip_smoke_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        save_checkpoint(ckpt, cfg, params, state, step=TRAIN_STEPS)
        p_r, s_r, step = restore_checkpoint(ckpt, cfg, params, state)
        io_s = time.perf_counter() - t0
        shutil.rmtree(ckpt)
        p_a, s_a, m_a = step_fn(params, state, batch)
        p_b, s_b, m_b = step_fn(p_r, s_r, batch)
        same = (step == TRAIN_STEPS and int(s_a.step) == int(s_b.step)
                and float(m_a["loss"]) == float(m_b["loss"])
                and all(torch.equal(a, b) for a, b in zip(
                    flatten((p_a, s_a.mu, s_a.nu)),
                    flatten((p_b, s_b.mu, s_b.nu)))))
        log(f"  checkpoint at step {step} saved and restored in {io_s:.1f} "
            f"s; the next step equals the step without the round trip, "
            f"bitwise: {same}")
        assert same
        del keep, p_a, s_a, p_b, s_b, p_r, s_r
        release(torch)
    return out


def _train_full(torch, dev, arch, kernels, keep):
    """``arch`` at full width and depth in bf16: TRAIN_STEPS steps of
    synthetic_batches (batch TRAIN_BATCH x seq TRAIN_SEQ, loss_chunk
    TRAIN_CHUNK, remat=True), the launch counts set to 0 just before and
    read just after; the loss falls; the forward kernel launched twice a
    layer a step (the forward and remat's recompute), its gradient once;
    then one more step traced. Returns the numbers, and with ``keep``
    what a checkpoint round trip needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params, init_params
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import make_train_step

    fwd, bwd = kernels
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    opt = AdamW(lr=1e-3, warmup_steps=5)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=True, loss_chunk=TRAIN_CHUNK)
    batches = list(synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     TRAIN_STEPS + 1, seed=0, device=dev))
    log(f"  {cfg.name}: {count_params(params) / 1e6:.1f} M params in bf16, "
        f"{cfg.n_layers} layers; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"loss_chunk {TRAIN_CHUNK}, remat, AdamW lr {opt.lr}, warm-up "
        f"{opt.warmup_steps}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))        # waits for the step
        times.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"  loss curve {[round(x, 4) for x in losses]}")
    log(f"  mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
        f"step ms {[round(1e3 * t, 1) for t in times]} (median after the "
        f"first {1e3 * step_s:.1f}), {tokens / step_s:.0f} tokens/s; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches {counts}: "
        f"{fwd} {counts[fwd]} (once in the forward and once in the "
        f"recompute of each layer), {bwd} {counts[bwd]}")
    assert all(map(math.isfinite, losses)) and last < first, losses
    assert counts[bwd] == cfg.n_layers * TRAIN_STEPS
    assert counts[fwd] == 2 * cfg.n_layers * TRAIN_STEPS
    traced = trace_step(torch, step_fn, params, state, batches[-1], bwd)
    res = dict(counts=counts, losses=losses, step_ms=1e3 * step_s,
               tokens_per_s=tokens / step_s, peak_bytes=peak, traced=traced,
               layers=cfg.n_layers)
    if not keep:
        return res, None
    return res, (cfg, step_fn, params, state, batches[-1])


def kernel_class(key):
    """The part of a training step a device kernel (a profiler row's
    demangled name) belongs to: a hand-written kernel by its wrapper,
    cuBLAS's products, PyTorch's own kernels, or other."""
    from repro_torch.launch.profile_serve import wrapper_of_key
    name = wrapper_of_key(key)
    if name is not None:
        return name
    low = key.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matrix products (cuBLAS)"
    if "at::native" in key:
        return "PyTorch's own kernels (elementwise, reductions, copies)"
    return "other"


def trace_step(torch, step_fn, params, state, batch, bwd):
    """One more train step under torch.profiler, after the timed ones, its
    results dropped: its wall time (tracing included), the device time by
    kernel (the top ones), by the op that launched it, and by part of the
    step, and each device kernel of the gradient wrapper ``bwd``'s share
    of the step. Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import (_device_us, report,
                                                  report_ops, wrapper_of_key)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = step_fn(params, state, batch)
        float(result[2]["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del result
    report("  [7t] traced step", prof, wall_ms)
    report_ops("  [7t] traced step", prof, top=12)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    parts = {}
    for e in kernels:
        ms, n = parts.get(kernel_class(e.key), (0.0, 0))
        parts[kernel_class(e.key)] = (ms + _device_us(e) / 1e3, n + e.count)
    for part, (ms, n) in sorted(parts.items(), key=lambda x: -x[1][0]):
        log(f"    {part}: {ms:.3f} ms of device time in {n} launches, "
            f"{100 * ms / max(dev_ms, 1e-9):.1f} % of the step's device "
            f"time")
    grads = {}
    for e in kernels:
        if wrapper_of_key(e.key) == bwd:
            ms = _device_us(e) / 1e3
            m = re.search(r"(\w+<[^()]*>)\(", e.key)
            name = m.group(1) if m else e.key
            grads[name] = grads.get(name, 0.0) + ms
            log(f"    gradient kernel {name}: {ms:.3f} ms in "
                f"{e.count} launches, {100 * ms / wall_ms:.1f} % of the "
                f"traced step's wall time, {100 * ms / max(dev_ms, 1e-9):.1f}"
                f" % of its device time")
    return dict(wall_ms=wall_ms, device_ms=dev_ms,
                parts={k: v[0] for k, v in parts.items()}, grads=grads)


ALL_PHASES = ("1", "2", "3", "3b", "3m", "3g", "3w", "3c", "3s", "3d", "3e",
              "3t", "4", "5", "5f", "4m", "5m", "4g", "5g", "4w", "5w", "4b", "7",
              "7t", "7r")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = {p for p in args.phases.split(",") if p}
    unknown = phases - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known: {ALL_PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import audio_requests, smoke_requests
    from repro_torch.models.params import count_params, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")
    build_s = _build.build_all()
    log(f"[1] kernels built in {build_s:.1f} s")
    for kname, text in _build.build_log.items():
        for fn, regs, spill, smem, mangled in ptxas_summary(text):
            dyn = (ssd_dynamic_smem(torch, mangled) if kname == "ssd_scan"
                   else None)
            log(f"    {kname}: {fn}: {regs} registers, spill {spill}, "
                f"shared {smem} bytes static"
                + (f" + {dyn} dynamic" if dyn is not None else ""))

    kernels, whisper_rows, groups = {}, {}, {}
    if "2" in phases:
        log("[2] kernels vs plain versions at the serving shapes")
        t0 = time.perf_counter()
        kernels = check_kernels(torch, dev)
        log("[2] the decode pair at glm4-9b's group of 16 and an MQA group "
            "of 32")
        groups = check_decode_groups(torch, dev)
        kernels["ssd_scan"] = check_ssd(torch, dev)
        whisper_rows = check_whisper_flash(torch, dev)
        log("[2] flash_attention_bwd vs autograd of the plain version at "
            "training shapes")
        bwd_rows = check_flash_bwd(torch, dev)
        kernels["flash_attention_bwd"] = dict(bwd_rows["smollm causal"],
                                              cases=bwd_rows)
        log("[2] ssd_scan_bwd vs the plain version of its arithmetic at "
            "mamba2-370m's training shapes")
        ssd_rows = check_ssd_bwd(torch, dev)
        kernels["ssd_scan_bwd"] = dict(
            ssd_rows["mamba2 train"], device_kernels=ssd_rows.pop(
                "device_kernels"), cases=ssd_rows)
        log(f"[2] {time.perf_counter() - t0:.1f} s")
    if "3" in phases:
        log("[3] model parity, llava-next-mistral-7b full width, 2 layers, "
            "f32, CPU plain vs GPU kernels")
        t0 = time.perf_counter()
        model_parity(torch, dev)
        log(f"[3] {time.perf_counter() - t0:.1f} s")
    if "3b" in phases:
        log("[3b] model parity, mamba2-370m full width, 2 layers, f32, "
            "CPU plain vs GPU ssd_scan")
        t0 = time.perf_counter()
        ssm_parity(torch, dev)
        log(f"[3b] {time.perf_counter() - t0:.1f} s")
    if "3m" in phases:
        log("[3m] model parity, mixtral-8x7b full width, 2 layers, f32, "
            "capacity factor 1.25, CPU plain vs GPU kernels, layer by layer")
        t0 = time.perf_counter()
        moe_parity(torch, dev)
        log(f"[3m] {time.perf_counter() - t0:.1f} s")
    if "3g" in phases:
        log(f"[3g] model parity, {', '.join(CONFIG_PARITY)} full width, 2 "
            f"layers, f32, CPU plain vs GPU kernels")
        t0 = time.perf_counter()
        config_parity(torch, dev)
        log(f"[3g] {time.perf_counter() - t0:.1f} s")
    if "3w" in phases:
        log("[3w] model parity, whisper-base full width and depth, f32, "
            "CPU plain vs GPU kernels, layer by layer")
        t0 = time.perf_counter()
        whisper_parity(torch, dev)
        log(f"[3w] {time.perf_counter() - t0:.1f} s")
    graph_counts = None
    if "3c" in phases:
        log("[3c] CUDA graphs: replay vs eager, bitwise, full width, 2 "
            "layers, bf16")
        t0 = time.perf_counter()
        graph_counts = graph_parity(torch, dev)
        log(f"[3c] {time.perf_counter() - t0:.1f} s")
    new_s = {}
    ranked_tp = None
    if "3s" in phases:
        log("[3s] the dry-run's case builders on the card: bf16, seed 0, "
            "under tp_rules of the 1x1 local mesh, bitwise against the "
            "entry points without rules")
        t0 = time.perf_counter()
        case_parity(torch, dev)
        new_s["3s"] = time.perf_counter() - t0
        log(f"[3s] {new_s['3s']:.1f} s")
    if "3d" in phases:
        log("[3d] dry-run on the meta device, 16x16 mesh, one case of each "
            "family (analytic terms at H100 SXM constants)")
        t0 = time.perf_counter()
        meta_dryrun(smi)
        new_s["3d"] = time.perf_counter() - t0
        log(f"[3d] {new_s['3d']:.1f} s")
    if "3e" in phases:
        log(f"[3e] the expert-parallel branch across ranks: mixtral-8x7b "
            f"full width, {MOE_LAYERS} layers, bf16, a process mesh of "
            f"{EP_MESH[0]} x {EP_MESH[1]}, against one process")
        t0 = time.perf_counter()
        expert_parallel_ranks(torch, dev, smi)
        new_s["3e"] = time.perf_counter() - t0
        log(f"[3e] {new_s['3e']:.1f} s")
    if "3t" in phases:
        log("[3t] tensor parallelism across ranks (the baseline rules): "
            f"the case builders' prefill {TP_PREFILL[0]} x {TP_PREFILL[1]} "
            f"and a decode step, full size, bf16, against one process")
        t0 = time.perf_counter()
        ranked_tp = tensor_parallel_ranks(torch, dev, smi)
        new_s["3t"] = time.perf_counter() - t0
        log(f"[3t] {new_s['3t']:.1f} s")

    serve_stats = {}
    attn = ("flash_attention", "decode_attention", "paged_decode_attention")
    if phases & {"4", "5", "5f"}:
        cfg = get_config("llava-next-mistral-7b")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[4] {cfg.name}: {count_params(params) / 1e9:.3f} B params in "
            f"bf16 ({cfg.n_layers} layers), made in "
            f"{time.perf_counter() - t0:.1f} s")
        if "4" in phases:
            log("[4] serve, dense: submit + run_until_done")
            serve_stats["dense"] = serve(
                torch, dev, cfg, params, "dense",
                smoke_requests(cfg, IMAGE_TOKENS), MAX_LEN, False,
                attn[:2])
        if "5" in phases:
            log(f"[5] serve, paged (prefix cache, chunked prefill 512): "
                f"run_continuous, {cfg.n_layers} layers")
            serve_stats["paged"] = serve(
                torch, dev, cfg, params, "paged",
                smoke_requests(cfg, IMAGE_TOKENS), MAX_LEN, True,
                (attn[0], attn[2]), paged=True, page_size=16,
                prefix_cache=True, chunked_prefill=True, prefill_chunk=512)
        if "5f" in phases:
            log(f"[5f] serve, paged, fp8 K/V (prefix cache, chunked prefill "
                f"512): run_continuous, {cfg.n_layers} layers")
            serve_stats["paged fp8"] = serve(
                torch, dev, cfg, params, "paged fp8",
                smoke_requests(cfg, IMAGE_TOKENS), MAX_LEN, True,
                (attn[0], attn[2]), kv_dtype=torch.float8_e4m3fn,
                paged=True, page_size=16, prefix_cache=True,
                chunked_prefill=True, prefill_chunk=512)
        if "paged" in serve_stats and "paged fp8" in serve_stats:
            same = (serve_stats["paged"]["outputs"]
                    == serve_stats["paged fp8"]["outputs"])
            pools = [serve_stats[m]["kv_bytes"]
                     for m in ("paged", "paged fp8")]
            log(f"[5f] bf16 and fp8 K/V greedy outputs identical: {same} "
                f"(not required); decode pool K/V {pools[0]} -> {pools[1]} "
                f"bytes")
        if "dense" in serve_stats and "paged" in serve_stats:
            same = (serve_stats["dense"]["outputs"]
                    == serve_stats["paged"]["outputs"])
            log(f"[5] dense and paged greedy outputs identical: {same} "
                f"(bf16; not required)")
        del params
        release(torch)
    if phases & {"4m", "5m"}:
        full = get_config("mixtral-8x7b")
        cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[4m] {cfg.name}: {count_params(params) / 1e9:.3f} B params in "
            f"bf16, made in {time.perf_counter() - t0:.1f} s; reduced: "
            f"n_layers {full.n_layers}->{cfg.n_layers}, bf16 weights "
            f"{2 * full.param_count() / 1e9:.1f}->"
            f"{2 * cfg.param_count() / 1e9:.1f} GB; max_len {MOE_MAX_LEN}, "
            f"prompts {MOE_PROMPTS}: A's {MOE_PROMPTS[0]} tokens pass the "
            f"{cfg.sliding_window}-token window in prefill and decode")
        if "4m" in phases:
            log("[4m] serve, dense: submit + run_until_done")
            t0 = time.perf_counter()
            serve_stats["mixtral dense"] = serve(
                torch, dev, cfg, params, "mixtral dense", moe_requests(cfg),
                MOE_MAX_LEN, False, attn[:2])
            log(f"[4m] {time.perf_counter() - t0:.1f} s")
        if "5m" in phases:
            log("[5m] serve, paged (prefix cache, chunked prefill 512): "
                "run_continuous, one live prefill, so that B's prefill finds "
                "A's pages in the prefix cache")
            t0 = time.perf_counter()
            serve_stats["mixtral paged"] = serve(
                torch, dev, cfg, params, "mixtral paged", moe_requests(cfg),
                MOE_MAX_LEN, True, (attn[0], attn[2]), hits="prefix",
                run_kw=dict(max_live_prefills=1), paged=True, page_size=16,
                prefix_cache=True, chunked_prefill=True, prefill_chunk=512)
            log(f"[5m] {time.perf_counter() - t0:.1f} s")
        del params
        release(torch)
    if phases & {"4g", "5g"}:
        from repro_torch.kernels.decode_attention.kernel import group_width
        cfg = get_config("glm4-9b")
        g = cfg.n_heads // cfg.n_kv_heads
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_par = count_params(params)
        log(f"[4g] {cfg.name}: {n_par / 1e9:.3f} B params, "
            f"{2 * n_par / 2 ** 30:.1f} GiB in bf16 ({cfg.n_layers} layers, "
            f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv heads of "
            f"{cfg.head_dim}: the decode pair at group width "
            f"{group_width(g)}), made in {time.perf_counter() - t0:.1f} s; "
            f"max_len {GLM_MAX_LEN}, prompts {GLM_PROMPTS}, 16 new tokens "
            f"each")
        if "4g" in phases:
            log("[4g] serve, dense: submit + run_until_done")
            t0 = time.perf_counter()
            reqs = glm_requests(cfg)
            serve_stats["glm4 dense"] = serve(
                torch, dev, cfg, params, "glm4 dense", reqs, GLM_MAX_LEN,
                False, attn[:2], probe=analytic_readings(torch, cfg, reqs,
                                                          smi))
            log(f"[4g] {time.perf_counter() - t0:.1f} s")
        if "5g" in phases:
            log("[5g] serve, paged (prefix cache, chunked prefill 512): "
                "run_continuous, one live prefill, so that B's prefill finds "
                "A's pages in the prefix cache")
            t0 = time.perf_counter()
            serve_stats["glm4 paged"] = serve(
                torch, dev, cfg, params, "glm4 paged", glm_requests(cfg),
                GLM_MAX_LEN, True, (attn[0], attn[2]), hits="prefix",
                run_kw=dict(max_live_prefills=1), paged=True, page_size=16,
                prefix_cache=True, chunked_prefill=True, prefill_chunk=512)
            log(f"[5g] {time.perf_counter() - t0:.1f} s")
        for mode, wrapper in (("glm4 dense", "decode_attention"),
                              ("glm4 paged", "paged_decode_attention")):
            if mode in serve_stats:
                log(f"[{mode}] the decode pair's launches, every one at "
                    f"group {g} (width {group_width(g)}): "
                    f"{serve_stats[mode]['counts'][wrapper]} {wrapper}")
        if "glm4 dense" in serve_stats and "glm4 paged" in serve_stats:
            dense = serve_stats["glm4 dense"]["outputs"]
            paged = serve_stats["glm4 paged"]["outputs"]
            log(f"[5g] dense and paged greedy outputs identical: "
                f"{dense == paged}")
            n = greedy_agreement(torch, dev, cfg, params, glm_requests(cfg),
                                 dense, paged)
            log(f"[5g] {n} of {len(dense)} requests' greedy tokens equal in "
                f"full; each other parts at a bf16 near-tie")
        del params
        release(torch)
    if phases & {"4w", "5w"}:
        cfg = get_config("whisper-base")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[4w] {cfg.name}: {count_params(params) / 1e6:.1f} M params in "
            f"bf16 ({cfg.encoder.n_layers} encoder layers over "
            f"{cfg.encoder.n_ctx} frames, {cfg.n_layers} decoder layers), "
            f"made in {time.perf_counter() - t0:.1f} s; max_len "
            f"{WHISPER_MAX_LEN}")
        if "4w" in phases:
            log("[4w] serve, dense: submit + run_until_done")
            t0 = time.perf_counter()
            st = serve_stats["whisper dense"] = serve(
                torch, dev, cfg, params, "whisper dense", audio_requests(cfg),
                WHISPER_MAX_LEN, False, attn[:2])
            assert st["store"].hits >= 1, st["store"]
            log(f"[4w] {time.perf_counter() - t0:.1f} s")
        if "5w" in phases:
            log("[5w] serve, paged (page 16): run_continuous, monolithic "
                "prefill jobs")
            t0 = time.perf_counter()
            serve_stats["whisper paged"] = serve(
                torch, dev, cfg, params, "whisper paged", audio_requests(cfg),
                WHISPER_MAX_LEN, True, (attn[0], attn[2]), paged=True,
                page_size=16)
            log(f"[5w] {time.perf_counter() - t0:.1f} s")
        if "whisper dense" in serve_stats and "whisper paged" in serve_stats:
            same = (serve_stats["whisper dense"]["outputs"]
                    == serve_stats["whisper paged"]["outputs"])
            log(f"[5w] dense and paged greedy outputs identical: {same}")
            assert same
        del params
        release(torch)
    if "4b" in phases:
        cfg = get_config("mamba2-370m")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[4b] {cfg.name}: {count_params(params) / 1e9:.3f} B params in "
            f"bf16 ({cfg.n_layers} layers), made in "
            f"{time.perf_counter() - t0:.1f} s; dense EPDCluster, max_len "
            f"{SSM_MAX_LEN}, prompts {SSM_PROMPTS}")
        for mode, continuous in (("mamba2 serial", False),
                                 ("mamba2 continuous", True)):
            log(f"[4b] serve {mode}: "
                f"{'run_continuous' if continuous else 'submit + run_until_done'}")
            serve_stats[mode] = serve(
                torch, dev, cfg, params, mode, ssm_requests(cfg),
                SSM_MAX_LEN, continuous, ("ssd_scan",))
        same = (serve_stats["mamba2 serial"]["outputs"]
                == serve_stats["mamba2 continuous"]["outputs"])
        log(f"[4b] serial and continuous greedy outputs identical: {same}")
        del params
        release(torch)

    train = None
    if "7" in phases:
        log(f"[7] training parity, {', '.join(TRAIN_MODELS)} full width, 2 "
            f"layers, f32, one step, CPU plain vs GPU kernels")
        t0 = time.perf_counter()
        train_parity(torch, dev)
        release(torch)
        log(f"[7] {time.perf_counter() - t0:.1f} s")
    if "7t" in phases:
        log(f"[7t] training {', '.join(TRAIN_MODELS)} at full width and "
            f"depth, bf16, {TRAIN_STEPS} steps")
        t0 = time.perf_counter()
        train = train_full(torch, dev)
        release(torch)
        log(f"[7t] {time.perf_counter() - t0:.1f} s")
    ranked_train = None
    if "7r" in phases:
        log(f"[7r] the train step across ranks: the case builders' train "
            f"case, {TRAIN_RANK_STEPS} steps, against one process")
        t0 = time.perf_counter()
        ranked_train = train_ranks(torch, dev, smi)
        new_s["7r"] = time.perf_counter() - t0
        log(f"[7r] {new_s['7r']:.1f} s")

    # -- 6. numbers ------------------------------------------------------------
    for mode, st in serve_stats.items():
        depth = (f" ({MOE_LAYERS} of 32 layers)" if mode.startswith("mixtral")
                 else " (40 layers, full size)" if mode.startswith("glm4")
                 else "")
        log(f"[6] {mode}{depth} on {smi}: TTFT ms {[round(x, 2) for x in st['ttft_ms']]} "
            f"(mean {statistics.mean(st['ttft_ms']):.2f}); TPOT ms "
            f"{[round(x, 3) for x in st['tpot_ms']]} (mean "
            f"{statistics.mean(st['tpot_ms']):.3f}); "
            f"{st['tokens_per_s']:.2f} output tokens/s over {st['wall_s']:.2f} s; "
            f"{st['graphs']['captures']} captures, {st['graphs']['replays']} "
            f"replays")
    for arch, run in (train or {}).items():
        tr = run["traced"]
        log(f"[6] training {arch} ({run['layers']} layers, bf16, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}) on {smi}: {run['step_ms']:.1f} "
            f"ms a step, {run['tokens_per_s']:.0f} tokens/s, peak "
            f"{run['peak_bytes'] / 2 ** 30:.2f} GiB allocated; traced step "
            f"{tr['wall_ms']:.1f} ms wall, {tr['device_ms']:.1f} ms device, "
            f"the gradient kernels {sum(tr['grads'].values()):.1f} ms")
    log(f"[6] total {time.perf_counter() - t_start:.1f} s, of which the "
        f"dry-run and rank phases {sum(new_s.values()):.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in new_s.items())})")

    rows = []
    trained = {bwd: arch for arch, (_, bwd) in TRAIN_MODELS.items()}
    for kname in KERNEL_INFO:
        r = kernels.get(kname, {})
        launches = sum(st["counts"][kname] for st in serve_stats.values())
        if kname in trained:
            run = (train or {}).get(trained[kname])
            launches = run["counts"][kname] if run else 0
        rows.append(dict(
            name=kname, route="cuda", **KERNEL_INFO[kname],
            launches=launches, max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), call_ms=r.get("call_ms"),
            library_call_ms=r.get("library_call_ms")))
        if "device_kernels" in r:
            rows[-1]["device_kernels"] = r["device_kernels"]
        if ranked_train and kname in ("flash_attention",
                                      "flash_attention_bwd", "ssd_scan",
                                      "ssd_scan_bwd"):
            # rank 0's launches in one train step of each 7r run
            rows[-1]["launches_7r"] = {
                run: v["launches"][kname] for run, v in ranked_train.items()
                if isinstance(v, dict)}
        if kname in trained:
            # the training shape of 7t above; the other cases below
            rows[-1]["launches_in"] = "7t"
            rows[-1]["cases"] = {case: {key: c[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "call_ms", "library_call_ms")}
                for case, c in r.get("cases", {}).items()}
        if "chunk" in r:
            rows[-1]["chunk"] = {key: r["chunk"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "call_ms", "library_call_ms")}
        if "fp8" in r:
            # K/V in float8_e4m3fn. Launches: paged decode in phase 5f's
            # serving; dense decode in phase 3c's dense fp8 engine (no
            # serving phase decodes a dense fp8 cache); null where that
            # phase did not run
            rows[-1]["fp8"] = {key: r["fp8"][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "call_ms", "library_call_ms")}
            if kname == "paged_decode_attention":
                run = serve_stats.get("paged fp8")
                n = run["counts"][kname] if run else None
                where = "5f"
            else:
                n = (graph_counts["llava dense fp8"][kname]
                     if graph_counts else None)
                where = "3c"
            rows[-1]["fp8"].update(launches=n, launches_in=where)
    # flash in whisper's two non-causal forms: its launches in 4w + 5w,
    # all of which are whisper's (encoder, cross and decoder self-attention)
    runs = [serve_stats[m] for m in ("whisper dense", "whisper paged")
            if m in serve_stats]
    for wname in ("flash_whisper_encoder", "flash_whisper_cross_decode"):
        r = whisper_rows.get(wname, {})
        rows.append(dict(
            name=wname, route="cuda", **KERNEL_INFO["flash_attention"],
            launches=sum(st["counts"]["flash_attention"] for st in runs),
            launches_in="4w+5w", max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), call_ms=r.get("call_ms"),
            library_call_ms=r.get("library_call_ms")))
    # glm4-9b's forms: flash at its prefill (launches in 4g + 5g), the
    # decode pair at its group of 16 (launches in 4g, dense, and 5g,
    # paged); the other group cases, MQA's 32 among them, under "cases"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "library_call_ms")
    runs = [serve_stats[m] for m in ("glm4 dense", "glm4 paged")
            if m in serve_stats]
    r = kernels.get("flash_attention_glm4", {})
    rows.append(dict(
        name="flash_attention_glm4", route="cuda",
        **KERNEL_INFO["flash_attention"],
        launches=sum(st["counts"]["flash_attention"] for st in runs),
        launches_in="4g+5g", **{k: r.get(k) for k in keys}))
    if "chunk" in r:
        rows[-1]["chunk"] = {k: r["chunk"][k] for k in keys[1:]}
    for wname, mode, where in (("decode_attention", "glm4 dense", "4g"),
                               ("paged_decode_attention", "glm4 paged",
                                "5g")):
        cases = groups.get(wname, {})
        r = cases.get("g16 bf16", {})
        run = serve_stats.get(mode)
        rows.append(dict(
            name=f"{wname}_group16", route="cuda", **KERNEL_INFO[wname],
            launches=run["counts"][wname] if run else 0, launches_in=where,
            **{k: r.get(k) for k in keys},
            cases={c: {k: v.get(k) for k in keys} for c, v in cases.items()}))
    # ssd_scan at a rank's heads under tensor parallelism (mamba2-370m at
    # 1 x 2: H 16): its launches in rank 0's prefill in phase 3t
    r = kernels.get("ssd_scan", {}).get("rank", {})
    run = (ranked_tp or {}).get("mamba2-370m 1x2")
    rows.append(dict(
        name="ssd_scan_rank_h16", route="cuda", **KERNEL_INFO["ssd_scan"],
        launches=run["prefill"]["launches"]["ssd_scan"] if run else 0,
        launches_in="3t", **{k: r.get(k) for k in keys}))
    if phases >= set(ALL_PHASES):
        for row in rows:
            assert row["launches"] > 0, row
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
