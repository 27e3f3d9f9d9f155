#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's twelve main paths through the entry points a user calls,
at full width, and holds every kernel of those paths against its plain
PyTorch version.  Phases, one line each:

1. device      the card's name and power limit, as nvidia-smi gives them;
2. build       the fused_conv3x3, flash_attention, fused_mlp,
               selective_scan and flash_attention_bwd kernels, built with
               nvcc from the checkout, one nvcc each, together; for
               flash_attention_bwd the registers, spills and HMMA
               instructions of each instantiation, failing if one that
               training launches has no HMMA; for flash_attention and fused_mlp
               the registers, spills and tensor-core (HMMA / HGMMA)
               instructions of each bfloat16 instantiation, failing if one
               that serving launches has none; for fused_conv3x3 those of
               its float32 (3xTF32) and bfloat16 instantiations, failing
               if one has no HMMA or spills;
3. paper flow  run_flow on the paper's configuration set and compare_fusion,
               held to the reference suite's locks (tests/test_flow.py);
4. exhaustive  run_flow over the 320-point default space x all 2^17 VGG-16
               groupings (41,943,040 candidates), held bit for bit to the
               scalar oracles (the best point and a seeded 4,096-cell sample);
5. forward     the 224x224 VGG-16 forward, batch 8, float32, through the
               kernel, against the plain forward;
   phases 3-5 are the first main path: the launch counts are zeroed just
   before and read just after it;
6. dag_search  the grouping search on DAGs -- the fourth main path, counts
               zeroed just before and read just after (it launches none of
               the four kernels): resnet18_ir (224x224), residual_block_ir
               and encoder_decoder_ir, the frontier DP's locked optima with
               their host ms, run_flow(groupings="search") on ResNet-18 over
               the default space and compare_fusion at the DP's cuts, and
               the exhaustive sweep of the encoder-decoder graph (320 x
               262,144 = 83,886,080 candidates), re-timed with CUDA events,
               a seeded 4,096-cell sample held bit for bit to the scalar
               oracles and its least bandwidth to the DP optimum's;
7. frontend    the tracing frontend -- the fifth main path, counts zeroed
               just before and read just after (it launches none of the
               four kernels): every model traced at full width over meta
               tensors on the host (VGG-16 both modes, ResNet-18 224x224,
               MobileNet 112x112, one superblock of each of the 11 registry
               configs at 512 tokens, falcon-mamba's mixer at 1 and 2
               chunks, the MoE FFN of the 4 MoE configs), each equal to the
               reference's trace and VGG-16 / ResNet-18 equal to the
               hand-built IRs, with nodes, edges and host seconds;
               run_flow(groupings="search") on the card over the traced
               ResNet-18, MobileNet, qwen3 block, falcon-mamba mixer and
               mixtral MoE FFN, each equal to the reference's best point,
               ResNet-18's bit for bit to the sweep of ir.resnet18_ir; the
               ResNet-18 forward (batch 8, float32 against float64) and one
               mixtral MoE layer at full width (bfloat16 against float32);
8. fleet       the fleet sweep -- the sixth main path, counts zeroed just
               before and read just after (it launches none of the four
               kernels): run_fleet over VGG-16 and the encoder-decoder with
               every valid grouping (one (2, 320, 262144, 5) float64 plane,
               125,829,120 candidates), each member equal to its run_flow of
               phases exhaustive and dag_search, the device sweep re-timed
               with CUDA events, sampled raw cells held to the scalar
               oracles; benchmarks/bench_shard.py's co-search (four
               workloads x 2,560 configurations, Pareto fronts) unsplit, split
               over the card twice (and every card), in 10 chunks, killed at
               each of the 9 inner chunk boundaries and resumed from its sweep
               checkpoint, and under faults (a split failing every sweep
               degrades to one device; a poisoned winning cell is quarantined
               at its global index) -- every answer equal to the reference's
               (FLEET_LOCKS);
9. service     the planning service -- the seventh main path, counts zeroed
               just before and read just after (no kernel launches):
               benchmarks/bench_serve.py's traffic (the MLP block, the
               residual block, the encoder-decoder, ResNet-18; three budgets;
               deadline 0.06 s) on the 320-point space, 80 requests at 25 QPS
               clean, under injected transient failures and eviction storms,
               and through the async transport; journaled, its first 40
               requests in a burst, killed with some in flight, recovered,
               and the other 40 paced; then 200 chaos requests.  Every
               request gets one typed response and every exact-rung plan
               equals an offline run_fleet bit for bit; p50 / p99 ms,
               achieved QPS, degradation and plan-cache hit rates, the outcome
               taxonomy and the recovery ms;
10. plan       plan_model for all 11 registry configs at 4096 tokens; every
               chosen tile (the selective scan's too, for the configs with
               Mamba layers) fits the card's opt-in shared memory;
11. serve      ``repro_torch.launch.serve.main`` on qwen3-0.6b at full width
               and depth (28 layers, bfloat16): 8 requests, prompt 512, 32
               generated tokens -- the second main path, counts zeroed just
               before and read just after: flash_attention once per layer
               in the prefill, fused_mlp once per layer per forward;
12. serve_time prefill ms, decode ms per token and tokens/s through the
               kernels and, for comparison, through their plain versions;
               prefill logits through the kernels against the plain path in
               bfloat16 and in float32; a profiled prefill and four decode
               steps;
13. serve_ssm  ``serve.main`` on falcon-mamba-7b at full width and depth (64
               layers, bfloat16), 8 requests, prompt 512, 32 generated
               tokens -- the third main path, counts zeroed just before and
               read just after: selective_scan once per layer in the prefill
               and once per layer per decode step, no flash_attention or
               fused_mlp;
14. serve_ssm_time   as serve_time, for falcon-mamba (the float32 logits at a
               cut depth, printed);
15. serve_moe  mixtral-8x7b at full width, 16 of its 32 layers (the 32-layer
               model's 93.1 GB of bfloat16 weights do not fit the card),
               through ``serve.run`` (runtime.steps' prefill and decode
               steps, as ``serve.main`` calls them), 8 requests, prompt 512,
               32 generated tokens -- the eighth main path, counts zeroed
               just before and read just after: flash_attention once per
               layer in the prefill (the sliding window of 4096), no
               fused_mlp (the experts are batched products, as in the
               reference);
16. serve_moe_time   as serve_time, for mixtral (the float32 logits at 2
               layers); the bfloat16 logits also against a kernel-free
               reordering of the attention (the router's top-2 may flip);
17. serve_encdec     ``serve.main`` on seamless-m4t-large-v2 at full width
               and depth (24 encoder + 24 decoder layers, bfloat16), 8
               requests of 1024 frames and a 512-token prompt, 32 generated
               tokens -- the ninth main path, counts zeroed just before and
               read just after: flash_attention 72 times in the prefill
               (the encoder's non-causal self-attention, the decoder's
               causal one, cross-attention over the frames), fused_mlp once
               per layer per forward (48 in the prefill, 24 a decode step);
18. serve_encdec_time   as serve_time, for seamless, both logits at full
               depth, the bfloat16 ones also against the reordering;
19. serve_ring gemma3-27b at full width, one superblock (5 sliding-window
               layers of 1024 + 1 global), 8 requests, prompt 1280, 32
               generated tokens, through runtime.steps with
               ``local_ring_cache`` and a ring cache -- the tenth main path,
               counts zeroed just before and read just after:
               flash_attention once per layer in the prefill, fused_mlp
               once per layer per forward; then the same tokens through the
               full cache: the logits within the bfloat16 tolerance,
               each cache's bytes;
20. layers     fused_conv3x3 vs its plain version at each of the 13 VGG-16
               conv shapes, with its time, the plain version's, a cuDNN
               yardstick's and the bound (float32: the smaller of the
               CUDA-core and the 3xTF32 bounds, both printed);
21. attention, mlp   flash_attention and fused_mlp vs their plain versions at
               the serving shapes of the five serving paths and at the
               shapes of tests/test_kernels.py (masks, the planner's tiles,
               float32 and bfloat16), with the same four times, and every
               built tile at qwen3's serving shapes; kernel phases time a
               launch over runs of CALLS launches and also one call alone;
22. scan       selective_scan vs its plain version at falcon-mamba's prefill
               and decode shapes, the shapes of tests/test_kernels.py and
               ragged ones, with its time, the plain version's and the bound
               (no single PyTorch call computes a selective scan); the
               decode row also replays its CALLS launches from a CUDA graph
               (``device_ms``: the kernel without the host's launch path);
23. train      ``repro_torch.launch.train.run`` on qwen3-0.6b at full width
               and depth (28 layers, bfloat16), train_4k's 4096 tokens, 16
               sequences a step in 4 microbatches, "full" remat and the
               custom-VJP flash attention, 8 steps through ResilientTrainer
               with a checkpoint after step 4 and one failure injected at
               step 7 -- the eleventh main path, counts zeroed just before
               and read just after: flash_attention twice per layer per
               microbatch (the forward and its recompute) and
               flash_attention_bwd once, no fused_mlp or selective_scan;
               the losses finite and falling, one failure and one restore,
               the replayed steps' losses against the first pass's, peak
               device memory;
24. train_time ms per step, tokens/s and model TFLOP/s (6 N D + attention)
               over three more steps, and a profiled step's device idle
               share;
25. train_parity   one microbatch's loss and every gradient leaf through the
               kernels against the plain attention, bfloat16 at full depth
               (also against a kernel-free reordering) and float32 at 2
               layers;
26. train_kernel   flash_attention_bwd vs its plain version at qwen3's
               training shape, windowed, chunked, hd 64 non-causal GQA,
               ragged and float32 shapes, two runs bit for bit, with its
               time, the plain version's, SDPA's backward and the bound;
               flash_attention with its logsumexp at the training shape;
27. train_sharded   the sharded training path -- the twelfth main path:
               qwen3-0.6b as in phase train, 3 steps through
               ``make_train_step(grad_shardings=...)`` on a (1, 1) ("data",
               "model") NCCL mesh of this process (counts zeroed just before
               and read just after: flash_attention twice and
               flash_attention_bwd once per layer per microbatch) against 3
               single-device steps from the same state and batches: losses
               bit-equal, every parameter and moment bit-equal (or within
               TRAIN_PARITY_TOL, the differing leaves printed), ms a step
               and peak memory of both; 8 steps of the int8-compressed step
               on a (1, 1, 1) ("pod", "data", "model") mesh (counts zeroed
               and read around them), losses finite and falling, every
               gradient leaf's payload handed to ``all_reduce`` as int8;
               ``resume_on_mesh`` of phase train's checkpoint, exactly the
               saved tensors; ``pipeline_apply`` at one stage, 6
               microbatches, bit-equal to the sequential result;
28. the kernels line, then the result line.

Usage: ``python3 chip_smoke.py [--seed N]`` from the root of a
checkout.  Exits non-zero, printing no result, without CUDA or outside a
checkout.  Writes every row to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"

# Kernel-vs-plain tolerances (atol = rtol), those of tests/test_kernels.py
# for conv (10x its TOLS): the kernel sums the 9*Cin products in another
# order than cuDNN, and a bfloat16 output may round to the neighbouring
# value from a float32 sum that differs in its last bits.
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# Fused-vs-plain logits, relative to the largest logit: the float32
# per-layer tolerance above (13 layers of reordered float32 sums).
LOGIT_TOL = 2e-4
BATCH = 8  # images per forward on the main path
REPS = 10  # timed runs per measurement
CALLS = 10  # launches in a row per timed run of a kernel phase
SAMPLE_CELLS = 4096  # raw-plane cells held to the scalar oracles
# The TPU kernels replaced (the functions that reach pl.pallas_call).
REPLACES = {"fused_conv3x3": "src/repro/kernels/fused_conv.py:46",
            "flash_attention": "src/repro/kernels/fused_attention.py:78",
            "fused_mlp": "src/repro/kernels/fused_mlp.py:59",
            "selective_scan": "src/repro/kernels/mamba_scan.py:51"}
# flash_attention / fused_mlp vs their plain versions (atol = rtol): the
# tolerances of tests/test_kernels.py (attention as there, the MLP at 10x):
# float32 sums are taken in another order (and the MLP's d_ff partial
# sums in the order its blocks finish), and a bfloat16 output may round to
# the neighbouring value from a float32 sum that differs in its last bits.
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLP_TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# Prefill logits through the kernels vs the plain path, relative to the
# largest logit.  float32: 28 layers, each within the per-kernel float32
# tolerances above (2e-5 attention, 2e-4 MLP, relative), whose differences
# add along the residual stream: 28 x 2e-5 < 1e-3.  bfloat16: both paths
# round every kernel output to bfloat16 at the same places, but a float32
# sum that differs in its last bit can round to the neighbouring bfloat16
# value (2^-8 = 3.9e-3 relative), and such flips propagate through the
# later layers: 5e-2.
PREFILL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# The serving run of the second main path.
SERVE = {"arch": "qwen3", "requests": 8, "prompt_len": 512, "gen": 32}
# The serving run of the third main path, and its float32 comparison's
# depth: 8 of the 64 layers at full width (a float32 copy of all 64 is 29 GB
# beside the 14.6 GB bfloat16 model the phase has just served).
SERVE_SSM = {"arch": "falcon-mamba", "requests": 8, "prompt_len": 512, "gen": 32}
SSM_F32_LAYERS = 8
# selective_scan vs its plain version (atol = rtol): tests/test_kernels.py's
# scan tolerance.  The kernel takes a * h + b as one FMA and sums the ds
# products of the readout in its own order; the plain version rounds the
# product and the sum apart and reads out with a batched matrix product.
SCAN_TOL = 1e-4
# falcon-mamba's prefill logits through the kernel vs the plain path,
# relative to the largest logit.  The selective scan is the only fusion
# group the two paths take differently.  float32 (8 layers): each scan
# within SCAN_TOL, and the differences add along the residual stream:
# 8 x 1e-4 < 1e-3.  bfloat16 (64 layers): both paths round y + D x to
# bfloat16 at the same place, but a float32 scan output that differs in its
# last bits can round to the neighbouring bfloat16 value (2^-8 = 3.9e-3
# relative), and such flips propagate through the later layers, as in
# qwen3's 28 (PREFILL_TOL): 5e-2.
SSM_PREFILL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# Over falcon-mamba's 64 bfloat16 layers that 5e-2 is too tight (5.4 % of
# the largest logit measured on an H100, PERF.md): once a flipped rounding
# has moved the residual stream by a bfloat16 unit, later layers round
# differently too, and the difference grows to bfloat16's own noise over
# the whole depth, whatever float32 reordering started it.  So the
# bfloat16 check also allows CONTROL_FACTOR times what a kernel-free
# reordering moves the same logits by: the plain path with the reference
# model's own scan (the chunk-recurrent associative scan,
# ssm.selective_scan_chunked at RunConfig.mamba_chunk) in place of the
# sequential one.  2: the two differences are maxima over 8 x 65,024
# logits of the same kind of noise.  The float32 check keeps its fixed
# tolerance; the scan phase holds the kernel itself to 1e-4.  The MoE and
# encoder-decoder serves take the same rule, with the plain path's
# attention summed over key blocks (the reference's attention_chunked
# order, :func:`blocked_attention`) as their reordering: mixtral's router
# picks its top-2 experts from bfloat16 states, so a flipped rounding can
# move a token to another expert and change its FFN output wholesale, and
# seamless runs 48 bfloat16 layers.
CONTROL_FACTOR = 2.0
CONTROL_KV_BLOCK = 64  # keys per block of the reordered attention (serve's attn_chunk_kv)
# The serving run of the eighth main path: mixtral-8x7b at full width and
# 16 of its 32 layers (all 32 hold 93.1 GB of bfloat16 weights, more than
# the card's 80 GB; 16 hold 46.7 GB), and its float32 comparison's depth (2
# layers, 12.1 GB, built after the bfloat16 weights are freed).
SERVE_MOE = {"arch": "mixtral", "requests": 8, "prompt_len": 512, "gen": 32,
             "n_layers": 16}
MOE_F32_LAYERS = 2
# The ninth: seamless-m4t-large-v2 at full width and depth; each request
# also carries the stub speech encoder's 1024 frames (cfg.frontend_len).
SERVE_ENCDEC = {"arch": "seamless", "requests": 8, "prompt_len": 512, "gen": 32}
# The tenth: gemma3-27b at full width, one superblock (5 sliding-window
# layers of 1024 and 1 global; 7.8 GB), with a prompt longer than the
# window, so the ring wraps in the prefill and again in decode.
SERVE_RING = {"arch": "gemma3", "requests": 8, "prompt_len": 1280, "gen": 32,
              "n_layers": 6}
# Logits through the ring against the full cache, relative to the largest
# logit.  Both run the same kernels on the same tokens: the prefill makes
# the same calls, but fused_mlp adds its d_ff partial sums with float
# atomics, in an order that changes from run to run; a decode step also
# sums attention_decode's float32 products over the cache in another order
# (the ring's 1024 slots, rolled, against the full cache's).  A float32 sum
# that differs in its last bit can round to the neighbouring bfloat16 value,
# which then propagates through the later layers: PREFILL_TOL's bfloat16
# 5e-2, argued the same way over 6 layers rather than 28.
RING_TOL = PREFILL_TOL["bfloat16"]
# flash_attention's bfloat16 shapes on the eighth to tenth main paths: (label,
# (B, Sq, Skv, H, KV, hd), causal, window), with the launches a serve makes.
SERVE_ATTENTION = [
    ("mixtral_prefill", (8, 512, 512, 32, 8, 128), True, 4096),      # 16
    ("seamless_encoder", (8, 1024, 1024, 16, 16, 64), False, 0),     # 24
    ("seamless_decoder", (8, 512, 512, 16, 16, 64), True, 0),        # 24
    ("seamless_cross", (8, 512, 1024, 16, 16, 64), False, 0),        # 24
    ("gemma3_local", (8, 1280, 1280, 32, 16, 128), True, 1024),      # 5
    ("gemma3_global", (8, 1280, 1280, 32, 16, 128), True, 0),        # 1
]
# fused_mlp's bfloat16 shapes there: (label, (T, d, ff, act)).
SERVE_MLP = [
    ("seamless_encoder", (8192, 1024, 8192, "relu")),   # 24 a serve
    ("seamless_prefill", (4096, 1024, 8192, "relu")),   # 24
    ("seamless_decode", (8, 1024, 8192, "relu")),       # 24 a step: 744
    ("gemma3_prefill", (10240, 5376, 21504, "geglu")),  # 6
    ("gemma3_decode", (8, 5376, 21504, "geglu")),       # 6 a step: 186
]

# The training run of the eleventh main path: qwen3-0.6b at full width and
# depth, train_4k's sequence length, a global batch of 16 sequences in 4
# microbatches (train_4k's global batch of 256 cut by the run's time limit),
# "full" remat and the custom-VJP flash attention, train_4k's peak learning
# rate (3e-4) reached after launch.train's warmup (max(steps // 10, 1) = 1
# step; train_4k's own 100 would leave 8 steps at under 2.4e-5); a
# checkpoint after step 4 (every 5 steps) and one failure injected at step 7,
# so steps 5 and 6 replay from the checkpoint.
TRAIN_RUN = {"arch": "qwen3", "batch": 16, "seq": 4096, "microbatches": 4,
             "steps": 8, "ckpt_every": 5, "fail_at": 7}
TRAIN_TIMED_STEPS = 3  # steps timed after the run (phase train_time)
# A replayed step's loss against the first pass's.  The first replayed step
# starts from the restored checkpoint, bit for bit, so its loss must be
# bit-equal.  A later one starts from the replayed update, whose gradients
# are sums the card may take in another order from run to run (cuBLAS and
# PyTorch's reductions promise run-to-run equality only for the same
# algorithm and launch configuration): within REPLAY_TOL relative if not
# bit-equal, with the cause printed.
REPLAY_TOL = 1e-3
# One-step parity, the loss and every gradient leaf through the kernels
# against the plain attention (relative L2 per leaf).  bfloat16 at full
# depth: the backward kernel rounds P and dS to bfloat16 for its products
# (2^-9 relative) where the plain version keeps float32, and every
# bfloat16 layer rounds again: 2e-2, or CONTROL_FACTOR x what a kernel-free
# reordering of the attention moves the same leaf by, if larger.  float32 at
# TRAIN_F32_LAYERS layers: float32 sums in other orders, 1e-3.
TRAIN_PARITY_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
TRAIN_F32_LAYERS = 2
# flash_attention_bwd vs its plain version, tests/test_flash_vjp.py's
# tolerances: float32 atol = rtol; bfloat16 of the largest |gradient|.
BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# The backward the kernel replaces: the TPU kernel has none, the training
# path differentiates through the custom VJP's backward in jnp.
REPLACES["flash_attention_bwd"] = "src/repro/models/flash.py:107"
# flash_attention_bwd's shapes: (label, (B, Sq, Skv, H, KV, hd), dtype,
# causal, window, chunk); "train" is qwen3's training microbatch.
TRAIN_KERNEL_CASES = [
    ("train", (4, 4096, 4096, 16, 8, 128), "bfloat16", True, 0, 0),
    ("window", (2, 1024, 1024, 16, 8, 128), "bfloat16", True, 256, 0),
    ("chunk", (2, 1024, 1024, 16, 8, 128), "bfloat16", True, 0, 256),
    ("hd64_noncausal_gqa4", (2, 512, 512, 16, 4, 64), "bfloat16", False, 0, 0),
    ("ragged", (2, 1000, 1000, 8, 4, 96), "bfloat16", True, 0, 0),
    ("float32", (2, 512, 512, 16, 8, 128), "float32", True, 0, 0),
    ("float32_ragged", (1, 333, 333, 4, 2, 64), "float32", True, 0, 0),
]

# The DAG search's locks (the reference's optima, tests/test_frontier_dp.py
# and tests/test_torch_search.py): (builder, SRAM budget words, group cost
# words, groups or None).
DAG_LOCKS = [("residual_block_ir", float("inf"), 200704.0, None),
             ("residual_block_ir", 150_000.0, 501760.0, None),
             ("encoder_decoder_ir", float("inf"), 720896.0, None),
             ("encoder_decoder_ir", 300_000.0, 11206656.0, None),
             ("resnet18_ir", float("inf"), 151528.0, 1),
             ("resnet18_ir", 200_000.0, 5670888.0, 11)]
# compare_fusion on ResNet-18 at the frontier DP's cuts, as the reference
# computes it: bandwidth, latency and energy reductions (within 1e-12).
RESNET_REDUCTIONS = (0.39744620408283005, 0.33105833902675863,
                     0.3235805468798656)

# The tracing frontend's locks: the reference frontend's traces of the same
# builders at full width (src/repro/core/frontend.py, run on the CPU), as
# (nodes, edges, the first 16 hex digits of the sha256 of the repr of the
# node and edge rows, each row a dataclasses.astuple).  VGG-16's traces are
# chains (no edges).
FRONTEND_LOCKS = {
    "vgg16_network(separate)": (18, 0, "9d9e8059cf1f1d9c"),
    "vgg16_network(absorbed)": (13, 0, "bd84f6d8e6e42525"),
    "resnet18_graph(224)": (31, 38, "041e85d9bf7bf0fe"),
    "mobilenet_graph(112)": (17, 18, "adb761095b08049c"),
    "transformer_graph(llama4-maverick-400b-a17b)": (1071, 1600, "8627e02c6222552e"),
    "transformer_graph(arctic-480b)": (528, 787, "69173b6bb08013bb"),
    "transformer_graph(internvl2-1b)": (12, 13, "f1b5f230828cc188"),
    "transformer_graph(granite-34b)": (10, 10, "b53377011e5dc5cc"),
    "transformer_graph(phi3-mini-3.8b)": (12, 13, "c3bee9bad2631855"),
    "transformer_graph(gemma3-27b)": (72, 98, "06ed0f606637d01f"),
    "transformer_graph(qwen3-0.6b)": (12, 13, "85726b5669ecb75c"),
    "transformer_graph(seamless-m4t-large-v2)": (10, 10, "bbc03910cfdb035f"),
    "transformer_graph(jamba-1.5-large-398b)": (372, 569, "b52633f25ed015c0"),
    "transformer_graph(falcon-mamba-7b)": (10, 15, "bc6681e0dc103eb1"),
    "transformer_graph(mixtral-8x7b)": (43, 60, "0a9a9201070f8011"),
    "mamba_graph(falcon-mamba-7b,1)": (9, 14, "dd4fdbc4e2ec1c50"),
    "mamba_graph(falcon-mamba-7b,2)": (20, 33, "88ca8a0d94fb5acf"),
    "moe_block_graph(llama4-maverick-400b-a17b)": (515, 770, "60299df2cee8b579"),
    "moe_block_graph(arctic-480b)": (520, 775, "b87ddab376dcf88d"),
    "moe_block_graph(jamba-1.5-large-398b)": (67, 98, "864d9ffc8b8b41b4"),
    "moe_block_graph(mixtral-8x7b)": (35, 50, "d041c4991de02cc7"),
}
FRONTEND_SEQ = 512  # tokens of every zoo trace (benchmarks/bench_zoo.py)
# The reference's run_flow(groupings="search") over its own traces of these
# graphs (default space; the zoo blocks under the loose constraints of
# benchmarks/bench_zoo.py, the CNNs under the paper's): best (style, f1,
# f2, f3, f4), group sizes, candidates, feasible, and the best point's
# (bandwidth words, latency cycles, energy nJ, area um^2).
FRONTEND_SWEEPS = {
    "resnet18_graph(224)": (("hsiao", 8, 2, 2, 4), (31,), 960, 788,
                            (11830440.0, 4754842.0, 16093645.28, 10772720.0)),
    "mobilenet_graph(112)": (("hsiao", 8, 2, 2, 2), (17,), 640, 570,
                             (69760.0, 245660.0, 398238.72, 1518960.0)),
    "transformer_graph(qwen3-0.6b)": (
        ("hsiao", 16, 8, 16, 16), (12,), 640, 640,
        (18350080.0, 5357760.0, 283314749.44, 213469680.0)),
    "mamba_graph(falcon-mamba-7b,1)": (
        ("hsiao", 16, 16, 16, 16), (9,), 640, 640,
        (109314048.0, 28149904.0, 704205127.68, 1035311600.0)),
    "moe_block_graph(mixtral-8x7b)": (
        ("hsiao", 8, 16, 16, 16), (35,), 640, 640,
        (1415610368.0, 365175856.0, 5273031557.120001, 373377520.0)),
}
# The fleet co-search of benchmarks/bench_shard.py: four workloads over
# config_space_grid() (2,560 points), groupings="pool", Pareto fronts, no
# constraints.  The reference's result (src/repro/core/flow.py::run_fleet on
# the CPU), per workload: (candidates, feasible, Pareto points, flow_digest),
# held by tests/test_torch_fleet.py against the reference and the port.
FLEET_LOCKS = {
    "resnet18": (5120, 5120, 39, "441b82a6f502351f"),
    "residual_block": (5120, 5120, 37, "331e65f55cb8fde9"),
    "vgg16": (5120, 5120, 41, "b8a8088b2485da3c"),
    "encoder_decoder": (5120, 5120, 42, "c0f5e8e8d97da618"),
}
FLEET_CHUNK = 256  # hw_chunk of the co-search's resumed runs: 10 chunks
# ResNet-18's float32 logits on the card against its float64 forward,
# relative to the largest |logit|: LOGIT_TOL, the float32 tolerance of the
# VGG-16 forward (cuDNN with TF32 off sums each conv's products in its own
# order; 21 convs here against 13 there, each a few float32 ulps).
RESNET_F32_TOL = LOGIT_TOL
RESNET_BATCH = 8
# One mixtral-8x7b MoE layer at full width in bfloat16 against the same
# layer in float32, relative to the largest |y|, as PREFILL_TOL's bfloat16:
# both runs take the same bfloat16 input and the float32 router, so they
# route every token alike, and the bfloat16 run rounds the expert weights,
# h, the gated product, the expert outputs, the combine weights and y
# (2^-9 relative each).
MOE_BF16_TOL = 5e-2
MOE_TOKENS = 4096


def flow_digest(res) -> str:
    """The first 16 hex digits of the sha256 of a FlowResult's answer: the
    best hardware row, cuts and metrics, the counts, the grouping
    provenance and the Pareto front (FLEET_LOCKS)."""
    import hashlib

    m, f = res.best_metrics, res.pareto
    row = (res.best_hw.as_row().tolist(), res.best_cuts.tolist(),
           (m.bandwidth_words, m.latency_cycles, m.energy_nj, m.area_um2),
           tuple(int(s) for s in res.group_sizes), res.n_candidates,
           res.n_feasible, res.n_pruned, res.search_engine,
           None if f is None else (f.metrics.tolist(), f.hw_indices.tolist(),
                                   f.cut_indices.tolist(), f.cuts.tolist()))
    return hashlib.sha256(repr(row).encode()).hexdigest()[:16]


def fail(msg: str) -> None:
    """End the run: no result line, exit code 1."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    """Fail the run unless ``cond`` holds."""
    if not cond:
        fail(msg)


def time_ms(torch, fns: dict, reps: int, calls: int = 1) -> dict:
    """Median time (ms) of one call of each zero-argument callable in
    ``fns``, taken in turns (one sample of each per round) after two warm-up
    calls of each.  A sample is CUDA events around ``calls`` calls in a row,
    divided by ``calls``: with ``calls`` > 1 the host work of a call
    overlaps the device work of the one before, so the time is the device's
    unless the host is slower."""
    for fn in fns.values():
        fn()
        fn()
    samples = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                fn()
            e1.record()
            e1.synchronize()
            samples[k].append(e0.elapsed_time(e1) / calls)
    return {k: statistics.median(v) for k, v in samples.items()}


def event_ms(torch, fn) -> tuple:
    """(ms between CUDA events around one call of ``fn``, its result)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), res


def graph_ms(torch, fn) -> float:
    """ms of one call of ``fn`` with the host's launch path taken out: CALLS
    calls in a row captured in a CUDA graph, the median replay (timed as
    :func:`time_ms` times) divided by CALLS."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    ms = time_ms(torch, {"graph": graph.replay}, REPS)["graph"] / CALLS
    del graph
    return ms


def time_kernel(torch, fns: dict) -> tuple[dict, dict]:
    """A kernel phase's times: per launch over runs of CALLS launches (the
    device time, the rows' ``ms``) and one call between two events (the
    call's host cost included, the rows' ``call_ms``)."""
    return time_ms(torch, fns, REPS, CALLS), time_ms(torch, fns, REPS)


def phase_device(torch) -> str:
    """The card's name and power limit, one line as nvidia-smi prints it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def phase_build() -> dict:
    """Build the five kernel libraries from the checkout's sources, one
    nvcc each, all started together.  For the attention backward, each
    instantiation's registers, spills and HMMA / HGMMA instructions; fails
    if one that training launches has no HGMMA or spills.  For K2 and K3,
    whose bfloat16 bodies run on the tensor cores: each bf16
    instantiation's registers and spills (``-Xptxas -v``) and its HMMA /
    HGMMA instructions in the SASS (``cuobjdump -sass``); fails if a bf16
    instantiation that serving launches has none.  For K1, whose float32 (3xTF32) and bfloat16 bodies
    both run on the tensor cores, the same for every instantiation; fails
    if one has no HMMA or spills."""
    from repro_torch.kernels import (builder, flash_attention_bwd, fused_attention,
                                     fused_conv, fused_mlp)

    t0 = time.perf_counter()
    kernels = builder.all_kernels()
    builds = builder.build_many(kernels)
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "libraries": {}, "tensor_core": {}}
    for kernel, built in zip(kernels, builds):
        report = builder.ptxas_report(built.log)
        regs = [r.get("registers", 0) for r in report.values()]
        spilling = [n for n, r in report.items()
                    if r.get("spill_stores", 0) or r.get("spill_loads", 0)]
        print(f"phase build: {built.path.name} in {built.seconds:.3f} s, "
              f"{len(report)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, {len(spilling)} spilling")
        out["libraries"][kernel.name] = {"seconds": built.seconds,
                                         "kernels": len(report), "spilling": spilling}
    tc = fused_attention.DEFAULT_TILE
    bm, bf = fused_mlp.default_tile(SERVE["requests"] * SERVE["prompt_len"])
    dm, df = fused_mlp.default_tile(SERVE["requests"])
    serving = {  # the bf16 instantiations qwen3's serve launches (swiglu: gated)
        fused_attention.KERNEL.name: [f"flash_attention_mma_kernelILi128ELi{tc[0]}ELi{tc[1]}E"],
        fused_mlp.KERNEL.name: [f"fused_mlp_mma_prefill_kernelILi{bm}ELi{bf}ELb1E",
                                f"fused_mlp_mma_decode_kernelILi{dm}ELi{df}ELb1E"],
    }
    for kernel, built in zip(kernels, builds):
        if kernel.name not in serving:
            continue
        report = builder.ptxas_report(built.log)
        sass = builder.sass_counts(built.path)
        bf16 = sorted(n for n in sass if "_mma_" in n)
        f32 = [n for n in sass if "_f32_kernel" in n]
        for want in serving[kernel.name]:
            check(any(want in n for n in bf16),
                  f"{built.path.name}: no bf16 kernel {want} in the SASS")
        for name in bf16:
            ops, ptx = sass[name], report.get(name, {})
            short = name.split("_mma_", 1)[1].split("EEv", 1)[0]
            serve = any(w in name for w in serving[kernel.name])
            out["tensor_core"][f"{kernel.name}:{short}"] = {**ops, **ptx, "serving": serve}
            print(f"  {kernel.name} bf16 {short}{' (serving)' if serve else ''}: "
                  f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; {ptx.get('registers')} "
                  f"registers, spills {ptx.get('spill_stores')} / {ptx.get('spill_loads')} "
                  "bytes")
            check(not serve or ops["HMMA"] + ops["HGMMA"] > 0,
                  f"{kernel.name}'s serving instantiation {short} has no tensor-core "
                  "instruction in its SASS")
        n_tc = sum(1 for n in f32 if sass[n]["HMMA"] + sass[n]["HGMMA"])
        print(f"  {kernel.name}: {len(bf16)} bf16 kernels, "
              f"{sum(1 for n in bf16 if sass[n]['HMMA'] + sass[n]['HGMMA'])} with "
              f"tensor-core instructions; {len(f32)} float32 kernels, {n_tc} with")
    # The attention backward: every instantiation's registers, spills, HMMA
    # and HGMMA, and ptxas's notes where it serializes a kernel's wgmma; the
    # bf16 ones training launches (head_dim 128, on wgmma) must have HGMMA
    # and spill nothing.
    bwd = builds[kernels.index(flash_attention_bwd.KERNEL)]
    report = builder.ptxas_report(bwd.log)
    sass = builder.sass_counts(bwd.path)
    serialized = [line.split("in the function", 1)[-1].strip(" '")
                  for line in bwd.log.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    training = ("flash_bwd_dkdv_wgmma_kernelILi128E", "flash_bwd_dq_wgmma_kernelILi128E")
    for want in training:
        check(any(want in n for n in sass), f"{bwd.path.name}: no kernel {want} in the SASS")
    for name in sorted(n for n in sass if "flash_bwd_" in n):
        ops, ptx = sass[name], report.get(name, {})
        short = "flash_bwd_" + name.split("flash_bwd_", 1)[1].split("EEv", 1)[0]
        train = any(w in name for w in training)
        serial = any(name in f for f in serialized)
        spills = (ptx.get("spill_stores"), ptx.get("spill_loads"))
        out["tensor_core"][f"{flash_attention_bwd.KERNEL.name}:{short}"] = {
            **ops, **ptx, "training": train, "wgmma_serialized": serial}
        print(f"  {flash_attention_bwd.KERNEL.name} {short}{' (training)' if train else ''}: "
              f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; {ptx.get('registers')} registers, "
              f"spills {spills[0]} / {spills[1]} bytes"
              + ("; ptxas serializes its wgmma" if serial else ""))
        check(not train or ops["HGMMA"] > 0,
              f"flash_attention_bwd's training instantiation {short} has no HGMMA")
        check(not train or not any(spills),
              f"flash_attention_bwd's training instantiation {short} spills {spills} bytes")
    # K1: every instantiation (float32 3xTF32 and bfloat16, both tiles) is
    # launched by the VGG path or phase layers.
    conv = builds[kernels.index(fused_conv.KERNEL)]
    report = builder.ptxas_report(conv.log)
    sass = builder.sass_counts(conv.path)
    names = sorted(n for n in sass if "fused_conv3x3_kernel" in n)
    check(len(names) == 2 * len(fused_conv.TILES),
          f"{conv.path.name}: {len(names)} fused_conv3x3 kernels in the SASS, not "
          f"{2 * len(fused_conv.TILES)}")
    for name in names:
        ops, ptx = sass[name], report.get(name, {})
        short = name.split("fused_conv3x3_kernel", 1)[1].split("EEv", 1)[0]
        dname = "float32 3xTF32" if short.startswith("If") else "bfloat16"
        spills = (ptx.get("spill_stores"), ptx.get("spill_loads"))
        out["tensor_core"][f"{fused_conv.KERNEL.name}:{short}"] = {**ops, **ptx}
        print(f"  {fused_conv.KERNEL.name} {dname} {short}: {ops['HMMA']} HMMA; "
              f"{ptx.get('registers')} registers, spills {spills[0]} / {spills[1]} bytes")
        check(ops["HMMA"] > 0, f"fused_conv3x3 {short} has no HMMA in its SASS")
        check(not any(spills), f"fused_conv3x3 {short} spills {spills} bytes")
    print(f"phase build: wall {wall:.3f} s")
    return out


def phase_paper_flow(vgg) -> dict:
    """The paper's flow on its configuration set, with the reference locks."""
    from repro_torch.core.arch import (
        PAPER_CONSTRAINTS, PAPER_OPTIMAL_CONFIG, paper_config_space)
    from repro_torch.core.flow import compare_fusion, run_flow

    t0 = time.perf_counter()
    res = run_flow(vgg, config_space=paper_config_space(),
                   constraints=PAPER_CONSTRAINTS, groupings="pool",
                   device="cuda")
    cmp = compare_fusion(vgg, PAPER_OPTIMAL_CONFIG)
    seconds = time.perf_counter() - t0
    check(res.best_hw == PAPER_OPTIMAL_CONFIG,
          f"paper flow picked {res.best_hw.describe()}, not hsiao (4,4,4,4)")
    check(res.best_metrics.meets(PAPER_CONSTRAINTS),
          "paper flow's best point breaks the paper's constraints")
    reductions = {"bandwidth": (cmp.bw_reduction, 0.602),
                  "latency": (cmp.latency_reduction, 0.377),
                  "energy": (cmp.energy_reduction, 0.406)}
    for name, (got, want) in reductions.items():
        check(abs(got - want) <= 0.005,
              f"fusion cuts {name} by {got:.4f}, expected {want} +- 0.005")
    check(not cmp.lbl.meets(PAPER_CONSTRAINTS),
          "layer-by-layer meets the paper's constraints")
    check(cmp.fused.meets(PAPER_CONSTRAINTS),
          "fusion breaks the paper's constraints")
    print(f"phase paper_flow: best {res.best_hw.describe()} groups "
          f"{list(res.group_sizes)}; fusion cuts bandwidth "
          f"{cmp.bw_reduction:.4f}, latency {cmp.latency_reduction:.4f}, "
          f"energy {cmp.energy_reduction:.4f}; layer-by-layer meets=False, "
          f"fused meets=True; {seconds:.3f} s")
    return {"seconds": seconds, "bw_reduction": cmp.bw_reduction,
            "latency_reduction": cmp.latency_reduction,
            "energy_reduction": cmp.energy_reduction}


def phase_exhaustive(torch, np, vgg, seed: int) -> tuple:
    """The exhaustive sweep, held bit for bit to the scalar oracles; the
    phase's numbers and its FlowResult (phase fleet holds its own to it)."""
    from repro_torch.core import metrics as M
    from repro_torch.core.arch import default_config_space
    from repro_torch.core.flow import groupings_batch, run_flow, sweep_args
    from repro_torch.core.ir import as_graph

    space = default_config_space()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_flow(vgg, config_space=space, groupings="exhaustive",
                   device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = len(space) * 2 ** 17
    check(res.n_candidates == n,
          f"exhaustive sweep scored {res.n_candidates} candidates, not {n}")
    oracle = M.evaluate_ref(vgg, res.best_cuts, res.best_hw)
    check(oracle == res.best_metrics,
          f"best point {res.best_metrics} != scalar oracle {oracle}")

    # The raw plane again, on the device, timed with CUDA events, and a
    # seeded sample of its cells held to the oracles.
    g = as_graph(vgg)
    cuts = groupings_batch(g, "exhaustive")
    tensors = M.sweep_tensors(sweep_args(g, cuts, space),
                              torch.device("cuda"))
    holder = {}

    def sweep():
        holder["raw"] = M._evaluate_batch_graph(*tensors)

    device_ms = time_ms(torch, {"sweep": sweep}, reps=3)["sweep"]
    check_sampled_cells(torch, np, g, cuts, space, holder["raw"], seed)
    print(f"phase exhaustive: {n} candidates, {res.n_feasible} feasible, "
          f"best {res.best_hw.describe()} groups {list(res.group_sizes)} "
          f"(= scalar oracle; {SAMPLE_CELLS} sampled raw cells = oracles); "
          f"run_flow {wall:.3f} s = set-up {res.compile_seconds:.3f} s + "
          f"sweep {res.sweep_seconds:.3f} s ({res.candidates_per_second:.6g}"
          f" candidates/s) + host; device sweep {device_ms:.3f} ms "
          f"({n / device_ms * 1e3:.6g} candidates/s); device peak "
          f"{peak / 2 ** 30:.3f} GiB")
    return {"candidates": n, "n_feasible": res.n_feasible,
            "run_flow_s": wall, "setup_s": res.compile_seconds,
            "sweep_s": res.sweep_seconds,
            "candidates_per_s": res.candidates_per_second,
            "device_sweep_ms": device_ms, "device_peak_bytes": peak}, res


def check_sampled_cells(torch, np, g, cuts, space, raw, seed: int) -> None:
    """Hold SAMPLE_CELLS seeded cells of the raw (H, C, 5) plane ``raw`` (on
    the card) bit for bit to the scalar oracles."""
    from repro_torch.core import metrics as M

    rng = np.random.default_rng(seed)
    hs = rng.integers(0, len(space), SAMPLE_CELLS)
    cs = rng.integers(0, cuts.shape[0], SAMPLE_CELLS)
    got = raw[torch.as_tensor(hs, device="cuda"),
              torch.as_tensor(cs, device="cuda")].cpu().numpy()
    c_sram = M.sram_accesses_ref(g)
    c_pb = {}
    for i, (h, c) in enumerate(zip(hs.tolist(), cs.tolist())):
        hw = space[h]
        if h not in c_pb:
            c_pb[h] = M.pe_energy_count_ref(g, hw)
        want = (M.bandwidth_ref(g, cuts[c]), M.latency_ref(g, cuts[c], hw),
                c_sram, c_pb[h], M.area_ref(g, cuts[c], hw))
        have = tuple(float(v) for v in got[i])
        check(have == want,
              f"{g.name}: raw cell (h={h}, c={c}) = {have} != oracles {want}")


def phase_dag_search(torch, np, seed: int) -> tuple:
    """The grouping search on DAGs and its sweeps on the card: the graph
    builders, the frontier DP's locked optima (host ms each), ResNet-18's
    ``run_flow(groupings="search")`` and ``compare_fusion``, and the
    exhaustive sweep of the encoder-decoder graph (320 configurations x
    262,144 valid groupings), re-timed with CUDA events and held bit for bit
    to the scalar oracles.  Returns the phase's numbers and that sweep's
    FlowResult (phase fleet holds its own to it)."""
    from repro_torch.core import fusion, ir
    from repro_torch.core import metrics as M
    from repro_torch.core.arch import (PAPER_OPTIMAL_CONFIG, DLAConfig,
                                       default_config_space)
    from repro_torch.core.flow import compare_fusion, run_flow, sweep_args

    out = {"searches": []}
    resnet = ir.resnet18_ir()
    rb, ed = ir.residual_block_ir(), ir.encoder_decoder_ir()
    width = ir.topo_frontier_width(resnet, ir.min_width_topo_order(resnet))
    check((len(resnet.nodes), resnet.n_edges, width) == (31, 38, 2),
          f"resnet18_ir: {len(resnet.nodes)} nodes, {resnet.n_edges} edges, "
          f"frontier width {width}; expected 31, 38, 2")
    t0 = time.perf_counter()
    ed_cuts = fusion.enumerate_valid_edge_cuts(ed)
    enum_s = time.perf_counter() - t0
    check(rb.n_edges == 4 and ed.n_edges == 21 and ed_cuts.shape == (262_144, 21),
          f"residual block {rb.n_edges} edges, encoder-decoder {ed.n_edges} edges "
          f"and {ed_cuts.shape[0]} valid cut vectors; expected 4, 21, 262144")
    print(f"phase dag_search: resnet18_ir 31 nodes, 38 edges, frontier width 2; "
          f"residual block 4 edges; encoder-decoder 21 edges, 262144 valid cut "
          f"vectors (enumerated on the host in {enum_s:.3f} s)")

    graphs = {"residual_block_ir": rb, "encoder_decoder_ir": ed, "resnet18_ir": resnet}
    dp = {}
    for name, budget, cost, n_groups in DAG_LOCKS:
        t0 = time.perf_counter()
        res = fusion.optimal_cuts(graphs[name], sram_budget_words=budget)
        ms = (time.perf_counter() - t0) * 1e3
        check(res.engine == "frontier_dp" and res.exact
              and res.group_cost_words == cost
              and n_groups in (None, res.n_groups),
              f"{name} at {budget} words: {res.engine}, exact={res.exact}, "
              f"{res.group_cost_words} words, {res.n_groups} groups; expected "
              f"frontier_dp, {cost}, {n_groups} groups")
        dp[name, budget] = res
        out["searches"].append({"graph": name, "budget": budget, "cost": cost,
                                "n_groups": res.n_groups, "host_ms": ms})
        print(f"dag_search {name} budget {budget:g}: {res.engine} exact, "
              f"{res.group_cost_words:.1f} words, {res.n_groups} groups, "
              f"{ms:.3f} ms on the host")

    space = default_config_space()
    t0 = time.perf_counter()
    res = run_flow(resnet, config_space=space, groupings="search", device="cuda")
    wall = time.perf_counter() - t0
    check((res.n_candidates, res.n_feasible) == (960, 788),
          f"resnet18 search flow: {res.n_candidates} candidates, {res.n_feasible} "
          "feasible; expected 960, 788")
    check(res.best_hw == DLAConfig("hsiao", 8, 2, 2, 4) and res.group_sizes == (31,)
          and res.search_engine == "frontier_dp",
          f"resnet18 search flow: best {res.best_hw.describe()} groups "
          f"{list(res.group_sizes)} [{res.search_engine}]; expected hsiao (8,2,2,4), "
          "[31], frontier_dp")
    oracle = M.evaluate_ref(resnet, res.best_cuts, res.best_hw)
    check(oracle == res.best_metrics,
          f"resnet18 best point {res.best_metrics} != scalar oracle {oracle}")
    cmp = compare_fusion(resnet, PAPER_OPTIMAL_CONFIG,
                         fused_cuts=dp["resnet18_ir", float("inf")].cuts)
    got = (cmp.bw_reduction, cmp.latency_reduction, cmp.energy_reduction)
    check(all(abs(a - b) <= 1e-12 for a, b in zip(got, RESNET_REDUCTIONS)),
          f"resnet18 compare_fusion reductions {got} != {RESNET_REDUCTIONS}")
    print(f"dag_search resnet18 run_flow(groupings='search'): {res.n_candidates} "
          f"candidates, {res.n_feasible} feasible, best {res.best_hw.describe()} "
          f"groups {list(res.group_sizes)} [{res.search_engine}] (= scalar oracle) "
          f"in {wall:.3f} s; fusion at the DP's cuts cuts bandwidth {got[0]!r}, "
          f"latency {got[1]!r}, energy {got[2]!r}")
    out["resnet18_flow"] = {"wall_s": wall, "n_candidates": res.n_candidates,
                            "n_feasible": res.n_feasible, "reductions": got}

    # The largest DAG sweep: every valid grouping of the encoder-decoder.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_flow(ed, config_space=space, groupings="exhaustive", device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = len(space) * ed_cuts.shape[0]
    check(res.n_candidates == n,
          f"encoder-decoder sweep scored {res.n_candidates} candidates, not {n}")
    oracle = M.evaluate_ref(ed, res.best_cuts, res.best_hw)
    check(oracle == res.best_metrics,
          f"encoder-decoder best point {res.best_metrics} != scalar oracle {oracle}")
    tensors = M.sweep_tensors(sweep_args(ed, ed_cuts, space), torch.device("cuda"))
    holder = {}

    def sweep():
        holder["raw"] = M._evaluate_batch_graph(*tensors)

    device_ms = time_ms(torch, {"sweep": sweep}, reps=3)["sweep"]
    raw = holder["raw"][:, :ed_cuts.shape[0]]
    check_sampled_cells(torch, np, ed, ed_cuts, space, raw, seed)
    least = float(raw[..., 0].min())
    want = M.bandwidth_ref(ed, dp["encoder_decoder_ir", float("inf")].cuts)
    check(least == want,
          f"encoder-decoder plane's least bandwidth {least} != the DP optimum's {want}")
    host = wall - res.compile_seconds - res.sweep_seconds
    print(f"dag_search encoder-decoder exhaustive: {n} candidates, {res.n_feasible} "
          f"feasible, best {res.best_hw.describe()} groups {list(res.group_sizes)} "
          f"(= scalar oracle; {SAMPLE_CELLS} sampled raw cells = oracles; least "
          f"bandwidth {least:.1f} = the DP optimum's); enumeration {enum_s:.3f} s + "
          f"run_flow {wall:.3f} s = set-up {res.compile_seconds:.3f} s + sweep "
          f"{res.sweep_seconds:.3f} s ({res.candidates_per_second:.6g} candidates/s) "
          f"+ host {host:.3f} s; device sweep {device_ms:.3f} ms "
          f"({n / device_ms * 1e3:.6g} candidates/s); device peak "
          f"{peak / 2 ** 30:.3f} GiB")
    del holder, tensors, raw
    torch.cuda.empty_cache()
    out["encoder_decoder"] = {
        "candidates": n, "n_feasible": res.n_feasible, "enumeration_s": enum_s,
        "run_flow_s": wall, "setup_s": res.compile_seconds,
        "sweep_s": res.sweep_seconds, "host_s": host,
        "candidates_per_s": res.candidates_per_second, "device_sweep_ms": device_ms,
        "device_peak_bytes": peak, "least_bandwidth": least}
    return out, res


def graph_digest(g) -> str:
    """The first 16 hex digits of the sha256 of a traced graph's node and
    edge rows (FRONTEND_LOCKS)."""
    import dataclasses
    import hashlib

    nodes = g.nodes if hasattr(g, "nodes") else g.layers
    rows = ([dataclasses.astuple(n) for n in nodes],
            [dataclasses.astuple(e) for e in getattr(g, "edges", ())])
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def frontend_builders() -> dict:
    """name -> zero-argument builder of every trace FRONTEND_LOCKS holds."""
    from repro_torch.configs import REGISTRY
    from repro_torch.core import frontend as F

    out = {
        "vgg16_network(separate)": lambda: F.vgg16_network(pool_mode="separate"),
        "vgg16_network(absorbed)": lambda: F.vgg16_network(pool_mode="absorbed"),
        "resnet18_graph(224)": lambda: F.resnet18_graph(input_hw=224),
        "mobilenet_graph(112)": lambda: F.mobilenet_graph(input_hw=112),
    }
    for name, cfg in REGISTRY.items():
        out[f"transformer_graph({name})"] = (
            lambda cfg=cfg: F.transformer_graph(cfg, seq_len=FRONTEND_SEQ))
    for chunks in (1, 2):
        out[f"mamba_graph(falcon-mamba-7b,{chunks})"] = (
            lambda chunks=chunks: F.mamba_graph(REGISTRY["falcon-mamba-7b"],
                                                seq_len=FRONTEND_SEQ, chunks=chunks))
    for name, cfg in REGISTRY.items():
        if cfg.n_experts > 1:
            out[f"moe_block_graph({name})"] = (
                lambda cfg=cfg: F.moe_block_graph(cfg, seq_len=FRONTEND_SEQ))
    return out


def phase_frontend_traces() -> dict:
    """Every model traced at full width over meta tensors, on the host:
    nodes, edges and seconds of each, each graph equal to the reference's
    (FRONTEND_LOCKS), VGG-16 and ResNet-18 equal to the hand-built IRs."""
    from repro_torch.core import ir

    graphs, rows = {}, []
    for name, build in frontend_builders().items():
        t0 = time.perf_counter()
        g = build()
        secs = time.perf_counter() - t0
        nodes = g.nodes if hasattr(g, "nodes") else g.layers
        got = (len(nodes), len(getattr(g, "edges", ())), graph_digest(g))
        check(got == FRONTEND_LOCKS[name],
              f"frontend {name}: {got} != the reference's {FRONTEND_LOCKS[name]}")
        graphs[name] = g
        rows.append({"graph": name, "nodes": got[0], "edges": got[1],
                     "host_s": secs})
        print(f"frontend trace {name}: {got[0]} nodes, {got[1]} edges, "
              f"{secs:.3f} s on the host (= the reference's trace)")
    for mode in ("separate", "absorbed"):
        check(graphs[f"vgg16_network({mode})"] == ir.vgg16_ir(pool_mode=mode),
              f"traced VGG-16 ({mode}) != ir.vgg16_ir")
    hand = ir.resnet18_ir()
    traced = graphs["resnet18_graph(224)"]
    check(traced.nodes == hand.nodes and traced.edges == hand.edges,
          "traced ResNet-18 != ir.resnet18_ir")
    scan = next(n for n in graphs["mamba_graph(falcon-mamba-7b,1)"].nodes
                if n.kind == "scan")
    check((scan.n_in, scan.h_in, scan.w_in, scan.state_words)
          == (8192, 1, FRONTEND_SEQ, 131072),
          f"falcon-mamba scan node {scan}")
    total = sum(r["host_s"] for r in rows)
    print(f"phase frontend traces: {len(rows)} graphs in {total:.3f} s on the "
          f"host; VGG-16 (both modes) = ir.vgg16_ir, ResNet-18 = "
          f"ir.resnet18_ir; falcon-mamba's scan node {scan.n_in} channels, "
          f"frame 1 x {scan.w_in}, {scan.state_words} state words")
    return {"graphs": graphs, "rows": rows}


def flows_equal(np, a, b) -> bool:
    """Two FlowResults agree bit for bit (best point, counts, front if any)."""
    fa, fb = a.pareto, b.pareto
    return (a.best_hw == b.best_hw and np.array_equal(a.best_cuts, b.best_cuts)
            and a.best_metrics == b.best_metrics and a.group_sizes == b.group_sizes
            and (a.n_candidates, a.n_feasible, a.n_pruned, a.search_engine)
            == (b.n_candidates, b.n_feasible, b.n_pruned, b.search_engine)
            and (fa is None) == (fb is None)
            and (fa is None or (np.array_equal(fa.metrics, fb.metrics)
                                and np.array_equal(fa.cuts, fb.cuts)
                                and fa.configs == fb.configs)))


def phase_frontend_sweeps(np, graphs: dict) -> list:
    """run_flow(groupings="search") on the card over the traced ResNet-18,
    MobileNet, one attention block, one Mamba block and one MoE block, each
    held to the reference's result (FRONTEND_SWEEPS); the traced ResNet-18
    bit for bit to the same sweep over ir.resnet18_ir()."""
    from repro_torch.core import ir
    from repro_torch.core import metrics as M
    from repro_torch.core.arch import Constraints
    from repro_torch.core.flow import run_flow

    loose = Constraints(*[float("inf")] * 4)
    rows = []
    for name, (hw, groups, n_cand, n_feas, metrics) in FRONTEND_SWEEPS.items():
        g = graphs[name]
        kw = {} if name.startswith(("resnet", "mobilenet")) else {"constraints": loose}
        t0 = time.perf_counter()
        res = run_flow(g, groupings="search", pareto=True, device="cuda", **kw)
        wall = time.perf_counter() - t0
        b = res.best_hw
        m = res.best_metrics
        got = ((b.style, b.f1, b.f2, b.f3, b.f4), tuple(res.group_sizes),
               res.n_candidates, res.n_feasible,
               (m.bandwidth_words, m.latency_cycles, m.energy_nj, m.area_um2))
        check(got == (hw, groups, n_cand, n_feas, metrics),
              f"frontend sweep {name}: {got} != the reference's "
              f"{(hw, groups, n_cand, n_feas, metrics)}")
        check(M.evaluate_ref(g, res.best_cuts, res.best_hw) == m,
              f"frontend sweep {name}: best point != the scalar oracle")
        row = {"graph": name, "wall_s": wall, "setup_s": res.compile_seconds,
               "sweep_s": res.sweep_seconds, "n_candidates": res.n_candidates,
               "n_feasible": res.n_feasible, "engine": res.search_engine,
               "best_hw": list(got[0]), "groups": list(got[1]),
               "best": list(got[4]), "pareto_points": res.pareto.size}
        if name == "resnet18_graph(224)":
            hand = run_flow(ir.resnet18_ir(), groupings="search", pareto=True,
                            device="cuda")
            check(flows_equal(np, res, hand),
                  "the traced ResNet-18's sweep differs from ir.resnet18_ir's")
            row["equals_hand_built"] = True
        rows.append(row)
        print(f"frontend sweep {name}: {res.n_candidates} candidates, "
              f"{res.n_feasible} feasible, best {b.describe()} groups "
              f"{list(res.group_sizes)} [{res.search_engine}], bandwidth "
              f"{m.bandwidth_words!r} words, energy {m.energy_nj!r} nJ (= the "
              f"reference's and the scalar oracle's"
              + ("; = ir.resnet18_ir's sweep bit for bit" if "equals_hand_built" in row
                 else "")
              + f"); run_flow {wall * 1e3:.3f} ms = set-up "
              f"{res.compile_seconds * 1e3:.3f} ms + sweep "
              f"{res.sweep_seconds * 1e3:.3f} ms + host")
    return rows


def phase_frontend_forwards(torch, seed: int) -> dict:
    """The traced models' own forwards on the card: ResNet-18 (batch 8,
    224x224, float32) against its float64 forward, and one mixtral-8x7b MoE
    layer at full width on MOE_TOKENS tokens, bfloat16 against float32."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import REGISTRY
    from repro_torch.models import moe, resnet

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = resnet.init_params(gen)
    x = torch.randn((RESNET_BATCH, 224, 224, 3), generator=gen, device="cuda")
    params64 = pytree.tree_map(lambda t: t.double(), params)
    with torch.inference_mode():
        y = resnet.forward(params, x)
        y64 = resnet.forward(params64, x.double())
        ms = time_ms(torch, {"f32": lambda: resnet.forward(params, x),
                             "f64": lambda: resnet.forward(params64, x.double())}, REPS)
    check(tuple(y.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(y).all()),
          f"ResNet-18 logits {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
    err = float((y.double() - y64).abs().max())
    scale = float(y64.abs().max())
    check(err <= RESNET_F32_TOL * scale,
          f"ResNet-18 float32 logits differ from float64 by {err} > "
          f"{RESNET_F32_TOL} x {scale}")
    print(f"phase frontend forward: ResNet-18 224x224 batch {RESNET_BATCH} "
          f"float32 {ms['f32']:.3f} ms, float64 {ms['f64']:.3f} ms; logits max "
          f"|float32 - float64| = {err:.6g} (max |logit| {scale:.6g}, tolerance "
          f"{RESNET_F32_TOL} x max)")
    out = {"resnet18": {"batch": RESNET_BATCH, "ms_float32": ms["f32"],
                        "ms_float64": ms["f64"], "max_abs_err": err,
                        "max_abs_logit": scale}}
    del params, params64, x, y, y64
    torch.cuda.empty_cache()

    cfg = REGISTRY["mixtral-8x7b"]
    p32 = moe.init_moe(gen, cfg, torch.float32)
    p16 = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in p32.items()}
    x16 = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                      device="cuda").to(torch.bfloat16)
    x32 = x16.float()
    with torch.inference_mode():
        y16, aux16 = moe.moe_block(p16, x16, cfg)
        y32, aux32 = moe.moe_block(p32, x32, cfg)
        ms = time_ms(torch, {"bf16": lambda: moe.moe_block(p16, x16, cfg),
                             "f32": lambda: moe.moe_block(p32, x32, cfg)}, REPS)
    check(y16.dtype == torch.bfloat16 and tuple(y16.shape) == tuple(x16.shape)
          and bool(torch.isfinite(y16).all()),
          f"MoE output {y16.dtype} {tuple(y16.shape)}")
    err = float((y16.float() - y32).abs().max())
    scale = float(y32.abs().max())
    aux_diff = abs(float(aux16) - float(aux32))
    check(err <= MOE_BF16_TOL * scale,
          f"MoE bfloat16 output differs from float32 by {err} > "
          f"{MOE_BF16_TOL} x {scale}")
    check(aux_diff <= 1e-6 * abs(float(aux32)),
          f"MoE aux loss {float(aux16)} (bfloat16) != {float(aux32)} (float32)")
    weights = sum(v.numel() * v.element_size() for v in p16.values())
    print(f"phase frontend forward: mixtral-8x7b MoE layer (d {cfg.d_model}, ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts, top-{cfg.top_k}, "
          f"{weights / 1e9:.3f} GB of bfloat16 weights) on {MOE_TOKENS} tokens: "
          f"bfloat16 {ms['bf16']:.3f} ms, float32 {ms['f32']:.3f} ms; max "
          f"|bfloat16 - float32| = {err:.6g} (max |y| {scale:.6g}, tolerance "
          f"{MOE_BF16_TOL} x max); aux loss {float(aux16)!r} / {float(aux32)!r}")
    out["moe"] = {"tokens": MOE_TOKENS, "weight_bytes_bf16": weights,
                  "ms_bfloat16": ms["bf16"], "ms_float32": ms["f32"],
                  "max_abs_err": err, "max_abs_y": scale,
                  "aux": [float(aux16), float(aux32)]}
    del p32, p16, x16, x32, y16, y32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The fleet sweep and the planning service (main paths 6 and 7)
# ---------------------------------------------------------------------------


def fleet_tensors(torch, np, graphs, space):
    """The exhaustive fleet's padded sweep arguments on the card, built as
    ``run_fleet`` builds them, and each graph's valid cut vectors."""
    from repro_torch.core import flow, ir
    from repro_torch.core import metrics as M

    e_b = ir.bucket_size(max(g.n_edges for g in graphs), flow.EDGE_BUCKET_FLOOR)
    l_b = ir.bucket_size(max(g.n_nodes for g in graphs), flow.NODE_BUCKET_FLOOR)
    pgs = [ir.pad_graph(g, n_nodes=l_b, n_edges=e_b) for g in graphs]
    cuts = [flow.groupings_batch(g, "exhaustive") for g in graphs]
    c_b = ir.bucket_size(max(len(c) for c in cuts), flow.CUT_BUCKET_FLOOR)
    args = (np.stack([p.feat for p in pgs]), np.stack([p.esrc for p in pgs]),
            np.stack([p.edst for p in pgs]), np.stack([p.ewords for p in pgs]),
            np.stack([p.src_mask for p in pgs]), np.stack([p.sink_mask for p in pgs]),
            np.stack([ir.pad_cuts_batch(c, e_b, c_b) for c in cuts]),
            np.stack([c.as_row() for c in space]), M.area_consts_of_space(space),
            np.stack([p.node_mask for p in pgs]), np.stack([p.edge_mask for p in pgs]))
    return M.sweep_tensors(args, torch.device("cuda")), cuts


def phase_fleet_exhaustive(torch, np, flows: dict, seed: int) -> dict:
    """``run_fleet([VGG-16, encoder-decoder], groupings="exhaustive")`` over
    the 320-point space: one (2, 320, 262144, 5) float64 plane, each
    member's answer equal to its run_flow of phases exhaustive and
    dag_search; the device sweep re-timed with CUDA events and a seeded
    sample of each member's raw cells held to the scalar oracles."""
    from repro_torch.core import ir
    from repro_torch.core import metrics as M
    from repro_torch.core.arch import default_config_space
    from repro_torch.core.flow import run_fleet

    space = default_config_space()
    graphs = {"vgg16_ir": ir.as_graph(ir.vgg16_ir(pool_mode="separate")),
              "encoder_decoder_ir": ir.encoder_decoder_ir()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fl = run_fleet(list(graphs.values()), config_space=space, groupings="exhaustive",
                   device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = len(space) * (2 ** 17 + 262_144)
    check(fl.n_candidates == n,
          f"exhaustive fleet scored {fl.n_candidates} candidates, not {n}")
    for (name, g), res in zip(graphs.items(), fl.results):
        check(flows_equal(np, res, flows[name]),
              f"exhaustive fleet's {name} answer {res.best_hw.describe()} "
              f"{res.best_metrics} ({res.n_feasible} feasible) != its run_flow's "
              f"{flows[name].best_hw.describe()} {flows[name].best_metrics} "
              f"({flows[name].n_feasible} feasible)")
    tensors, cuts = fleet_tensors(torch, np, list(graphs.values()), space)
    holder = {}

    def sweep():
        holder["raw"] = M._evaluate_fleet_graph(*tensors)

    device_ms = time_ms(torch, {"sweep": sweep}, reps=3)["sweep"]
    plane_bytes = holder["raw"].numel() * 8
    for gi, (g, c) in enumerate(zip(graphs.values(), cuts)):
        check_sampled_cells(torch, np, g, c, space, holder["raw"][gi][:, :len(c)],
                            seed + gi)
    host = wall - fl.compile_seconds - fl.sweep_seconds
    print(f"phase fleet exhaustive: VGG-16 + encoder-decoder, {n} candidates in one "
          f"(2, {len(space)}, {cuts[1].shape[0]}, 5) float64 plane "
          f"({plane_bytes / 1e9:.3f} GB); each member = its run_flow (best point, "
          f"cuts, metrics, {fl.results[0].n_feasible} / {fl.results[1].n_feasible} "
          f"feasible; {SAMPLE_CELLS} sampled raw cells each = oracles); run_fleet "
          f"{wall:.3f} s = set-up {fl.compile_seconds:.3f} s + sweep "
          f"{fl.sweep_seconds:.3f} s ({fl.candidates_per_second:.6g} candidates/s) + "
          f"host {host:.3f} s; device sweep {device_ms:.3f} ms "
          f"({n / device_ms * 1e3:.6g} candidates/s); device peak "
          f"{peak / 2 ** 30:.3f} GiB")
    del holder, tensors
    torch.cuda.empty_cache()
    return {"candidates": n, "plane_bytes": plane_bytes, "run_fleet_s": wall,
            "setup_s": fl.compile_seconds, "sweep_s": fl.sweep_seconds,
            "host_s": host, "candidates_per_s": fl.candidates_per_second,
            "device_sweep_ms": device_ms, "device_peak_bytes": peak}


class _Killed(Exception):
    """The co-search's simulated kill between two chunks."""


def _killer(n_allowed: int):
    """An abort_check letting ``n_allowed`` boundary checks pass."""
    calls = [0]

    def check_boundary():
        calls[0] += 1
        if calls[0] > n_allowed:
            raise _Killed(calls[0])

    return check_boundary


def check_fleet_locks(fl, what: str) -> None:
    """Every workload of a co-search run against FLEET_LOCKS."""
    for name, res in zip(FLEET_LOCKS, fl.results):
        got = (res.n_candidates, res.n_feasible, res.pareto.size, flow_digest(res))
        check(got == FLEET_LOCKS[name],
              f"co-search {what}: {name} {got} != the reference's {FLEET_LOCKS[name]}")


def phase_fleet_cosearch(torch, np, tmp: Path) -> dict:
    """benchmarks/bench_shard.py's co-search (four workloads x 2,560
    configurations, groupings="pool", Pareto fronts) on one device, split
    over the card twice (and every card, if more), chunked, killed at each
    inner chunk boundary and resumed, under injected faults — every answer
    equal to the reference's (FLEET_LOCKS)."""
    from repro_torch.core import ir
    from repro_torch.core.arch import Constraints, config_space_grid
    from repro_torch.core.errors import RetryPolicy
    from repro_torch.core.flow import groupings_batch, run_fleet
    from repro_torch.testing.faults import FaultInjector

    gs = [ir.resnet18_ir(), ir.residual_block_ir(),
          ir.as_graph(ir.vgg16_ir(pool_mode="separate")), ir.encoder_decoder_ir()]
    space = config_space_grid()
    kw = dict(config_space=space, constraints=Constraints(*[float("inf")] * 4),
              groupings="pool", pareto=True)
    rows = []

    def run(what, **extra):
        t0 = time.perf_counter()
        fl = run_fleet(gs, **kw, **extra)
        wall = time.perf_counter() - t0
        check_fleet_locks(fl, what)
        rows.append({"run": what, "wall_s": wall, "setup_s": fl.compile_seconds,
                     "sweep_s": fl.sweep_seconds, "device_count": fl.device_count,
                     "chunks_computed": fl.chunks_computed,
                     "chunks_restored": fl.chunks_restored,
                     "stragglers": list(fl.straggler_chunks),
                     "mesh_degraded": fl.mesh_degraded})
        return fl

    one = run("devices=None", device="cuda")
    layouts = [("cuda:0", "cuda:0")]
    if torch.cuda.device_count() > 1:
        layouts.append(tuple(f"cuda:{i}" for i in range(torch.cuda.device_count())))
    for layout in layouts:
        fl = run(f"devices={layout}", devices=layout)
        check(fl.device_count == len(layout), f"split over {layout}: {fl.device_count}")
    n_chunks = -(-len(space) // FLEET_CHUNK)
    chunked = run(f"hw_chunk={FLEET_CHUNK}", device="cuda", hw_chunk=FLEET_CHUNK)
    check(chunked.chunks_computed == n_chunks, f"{chunked.chunks_computed} chunks")
    restored = []
    for k in range(1, n_chunks):
        d = tmp / f"cosearch_kill_{k}"
        try:
            run_fleet(gs, **kw, device="cuda", hw_chunk=FLEET_CHUNK, checkpoint_dir=d,
                      abort_check=_killer(k))
            fail(f"the co-search was not killed at boundary {k}")
        except _Killed:
            pass
        fl = run(f"resumed after a kill at boundary {k}", device="cuda",
                 hw_chunk=FLEET_CHUNK, checkpoint_dir=d)
        check((fl.chunks_restored, fl.chunks_computed) == (k, n_chunks - k),
              f"resume after boundary {k}: {fl.chunks_restored} restored, "
              f"{fl.chunks_computed} computed")
        restored.append(fl.chunks_restored)

    # Faults on the card: a split whose every sweep fails degrades to its
    # first device; a poisoned cell is quarantined with its global index.
    sick = FaultInjector(mesh_fail_sweeps=10 ** 6)
    fl = run("sick split, degraded", devices=("cuda:0", "cuda:0"), hooks=sick,
             retry_policy=RetryPolicy(max_retries=2, backoff_seconds=0.0))
    check(fl.mesh_degraded and fl.device_count == 1
          and sick.counts["injected_mesh_failures"] == 3,
          f"sick split: degraded={fl.mesh_degraded}, {sick.counts}")
    g_i = 3  # the encoder-decoder: poison its winning cell
    best = one.results[g_i]
    h = next(i for i, c in enumerate(space) if c == best.best_hw)
    c = next(i for i, row in enumerate(groupings_batch(gs[g_i], "pool"))
             if np.array_equal(row, best.best_cuts))
    inj = FaultInjector(poison_cell=(g_i, h, c))
    fl = run_fleet(gs, **kw, device="cuda", hw_chunk=FLEET_CHUNK, hooks=inj)
    cells = [(q.graph, q.hw, q.cut, q.reason) for q in fl.quarantine.cells]
    res = fl.results[g_i]
    check(cells == [(g_i, h, c, "nan")] and inj.counts["poisoned_cells"] == 1,
          f"poisoned cell {(g_i, h, c)}: quarantined {cells}")
    check(not (res.best_hw == best.best_hw and np.array_equal(res.best_cuts, best.best_cuts))
          and res.n_feasible == best.n_feasible - 1 and np.isfinite(res.pareto.metrics).all(),
          "the poisoned winner was chosen again")
    for gi, (a, b) in enumerate(zip(fl.results, one.results)):
        check(gi == g_i or flows_equal(np, a, b), f"poisoning moved workload {gi}")
    setup = [r["setup_s"] for r in rows]
    print(f"phase fleet co-search: 4 workloads x {len(space)} configurations "
          f"(groupings=pool, Pareto fronts of "
          f"{[r.pareto.size for r in one.results]} points): devices=None, "
          f"{', '.join(str(lay) for lay in layouts)}, hw_chunk={FLEET_CHUNK} and "
          f"{len(restored)} kill-and-resume runs (chunks restored {restored}) all = "
          f"FLEET_LOCKS; sick split degraded to one device after "
          f"{sick.counts['injected_mesh_failures']} failures, = FLEET_LOCKS; "
          f"the encoder-decoder's winning cell (g={g_i}, h={h}, c={c}) poisoned "
          f"with NaN: quarantined at its global index, not chosen; run_fleet "
          f"{rows[0]['wall_s'] * 1e3:.3f} ms unsplit, "
          f"{rows[1]['wall_s'] * 1e3:.3f} ms split over {layouts[0]}, "
          f"{rows[len(layouts) + 1]['wall_s'] * 1e3:.3f} ms in {n_chunks} chunks; "
          f"set-up {min(setup) * 1e3:.3f}-{max(setup) * 1e3:.3f} ms")
    return {"runs": rows, "pareto_points": [r.pareto.size for r in one.results],
            "poisoned": [g_i, h, c]}


SERVICE_N = 80  # requests per stream (benchmarks/bench_serve.py)
SERVICE_QPS = 25.0  # offered load of the paced streams
SERVICE_DEADLINE_S = 0.06  # per-request deadline (bench_serve.DEADLINE_S)
SERVICE_BUDGETS = (float("inf"), 4e6, 1e6)  # SRAM budgets, cycled
SERVICE_KILL_AT = 40  # the journaled stream's crash, after this many submissions
SERVICE_CHAOS = 200  # chaos_requests in the chaos stream


def _percentile(xs: list, q: float) -> float:
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))] if ys else float("nan")


def _paced(svc, requests) -> list:
    """Submit ``requests`` at SERVICE_QPS to a synchronous service, ticking
    while waiting for the next arrival; returns their request ids."""
    interval, t_start, rids = 1.0 / SERVICE_QPS, time.perf_counter(), []
    for i, req in enumerate(requests):
        target = t_start + i * interval
        while time.perf_counter() < target:
            if svc.queue_depth:
                svc.tick()
            else:
                time.sleep(min(1e-4, max(0.0, target - time.perf_counter())))
        rids.append(svc.submit(req))
    return rids


def stream_stats(np, requests, resps, latencies, wall, offline: dict) -> dict:
    """A stream's numbers, its contract checked: one typed response per
    request, and every ok exact-rung plan equal, bit for bit, to an offline
    ``run_fleet(groupings="search")`` of its graph and budget on the card."""
    from repro_torch.core.arch import Constraints
    from repro_torch.core.errors import EvaluatorError
    from repro_torch.core.flow import run_fleet

    check(len(resps) == len(requests) and all(
        r is not None and (r.ok or isinstance(r.error, EvaluatorError)) for r in resps),
        "a request got no typed response")
    outcomes: dict = {}
    n_exact = 0
    for req, r in zip(requests, resps):
        key = f"ok:{r.rung}" if r.ok else r.error_type
        outcomes[key] = outcomes.get(key, 0) + 1
        if not (r.ok and r.rung == "exact"):
            continue
        k = (req.graph, req.sram_budget_words)
        if k not in offline:
            offline[k] = run_fleet([req.graph], constraints=Constraints(*[float("inf")] * 4),
                                   groupings="search", device="cuda",
                                   sram_budget_words=req.sram_budget_words).results[0]
        check(flows_equal(np, r.plan, offline[k]),
              f"exact plan for {req.graph.name} at budget {req.sram_budget_words} != "
              "the offline run_fleet")
        n_exact += 1
    n_ok = sum(r.ok for r in resps)
    return {"n": len(resps), "achieved_qps": len(resps) / wall,
            "p50_ms": _percentile(latencies, 0.5) * 1e3,
            "p99_ms": _percentile(latencies, 0.99) * 1e3, "ok_rate": n_ok / len(resps),
            "degradation_rate": sum(r.ok and r.degraded for r in resps) / max(n_ok, 1),
            "cache_hit_rate": sum(r.ok and r.from_cache for r in resps) / max(n_ok, 1),
            "exact_plans_checked": n_exact, "outcomes": outcomes}


def print_stream(name: str, st: dict, extra: str = "") -> None:
    print(f"phase service {name}: {st['n']} requests at {SERVICE_QPS:g} QPS offered, "
          f"{st['achieved_qps']:.3f} achieved; p50 {st['p50_ms']:.3f} ms, p99 "
          f"{st['p99_ms']:.3f} ms; ok {st['ok_rate']:.4f}, degraded "
          f"{st['degradation_rate']:.4f}, plan-cache hits {st['cache_hit_rate']:.4f}; "
          f"{st['exact_plans_checked']} exact plans = the offline run_fleet; "
          f"outcomes {st['outcomes']}{extra}")


def phase_service(torch, np, tmp: Path, seed: int) -> dict:
    """benchmarks/bench_serve.py's traffic through the planning service on
    the card: four graphs x three budgets, deadline 0.06 s, 80 requests at
    25 QPS — clean, under injected faults, through the async transport, and
    journaled, killed after a burst of 40 submissions and recovered — then
    the chaos stream.  Every request gets exactly one typed response."""
    import concurrent.futures

    from repro_torch.core.arch import Constraints
    from repro_torch.core.ir import resnet18_ir
    from repro_torch.core.service import (AsyncPlanningService, PlanningService,
                                          PlanRequest)
    from repro_torch.testing.faults import FaultInjector, _valid_graphs, chaos_requests

    graphs = _valid_graphs() + [resnet18_ir()]
    requests = [PlanRequest(graph=graphs[i % len(graphs)],
                            sram_budget_words=SERVICE_BUDGETS[i % len(SERVICE_BUDGETS)],
                            deadline_seconds=SERVICE_DEADLINE_S)
                for i in range(SERVICE_N)]
    kw = dict(constraints=Constraints(*[float("inf")] * 4), backoff_seconds=0.0,
              max_batch=16, max_queue_depth=4 * SERVICE_N, device="cuda")
    offline, out = {}, {}
    for name, faults in (("clean", None),
                         ("faults", FaultInjector(transient_every=3, evict_every=5))):
        svc = PlanningService(faults=faults, **kw)
        check(svc.plan(PlanRequest(graph=graphs[0])).ok, "the warm-up plan failed")
        t0 = time.perf_counter()
        rids = _paced(svc, requests)
        svc.drain()
        wall = time.perf_counter() - t0
        resps = [svc.collect(rid) for rid in rids]
        st = stream_stats(np, requests, resps, [r.latency_seconds for r in resps],
                          wall, offline)
        st["transient_retries"] = svc.stats()["counters"].get("transient_retries", 0)
        extra = ""
        if faults is not None:
            st["injected"] = dict(faults.counts)
            check(faults.counts["injected_transients"] > 0
                  and faults.counts["evict_storms"] > 0, f"no fault fired: {faults.counts}")
            extra = (f"; injected {faults.counts['injected_transients']} transient sweep "
                     f"failures ({st['transient_retries']} retries), "
                     f"{faults.counts['evict_storms']} eviction storms")
        out[name] = st
        print_stream(name, st, extra)

    asvc = AsyncPlanningService(**kw)
    check(asvc.plan(PlanRequest(graph=graphs[0]), timeout=300).ok, "async warm-up failed")
    latencies, futs = [], []
    interval, t0 = 1.0 / SERVICE_QPS, time.perf_counter()
    for i, req in enumerate(requests):
        while time.perf_counter() < t0 + i * interval:
            time.sleep(min(1e-4, max(0.0, t0 + i * interval - time.perf_counter())))
        t_sub = time.perf_counter()
        fut = asvc.submit(req)
        fut.add_done_callback(lambda f, t=t_sub: latencies.append(time.perf_counter() - t))
        futs.append(fut)
    concurrent.futures.wait(futs, timeout=300)
    wall = time.perf_counter() - t0
    asvc.shutdown(drain=True, timeout=300)
    check(all(f.done() for f in futs), "an async future never resolved")
    out["async"] = stream_stats(np, requests, [f.result() for f in futs], latencies,
                                wall, offline)
    print_stream("async", out["async"], " (submit to future resolution, shut down with "
                 "drain=True)")

    # Journaled: the first SERVICE_KILL_AT requests arrive as a burst (one
    # tick per 10 arrivals, none after the last), so the crash right after
    # them leaves answered and in-flight requests; recovery replays the WAL,
    # re-runs what was in flight, and serves the rest of the stream paced.
    jdir = tmp / "service_journal"
    svc = PlanningService(journal_dir=jdir, journal_fsync=True, snapshot_every=0, **kw)
    t0 = time.perf_counter()
    rids = []
    for i, req in enumerate(requests[:SERVICE_KILL_AT]):
        rids.append(svc.submit(req))
        if i % 10 == 9 and i + 1 < SERVICE_KILL_AT:
            svc.tick()
    in_flight = svc.queue_depth
    check(in_flight > 0, "nothing was in flight at the crash")
    svc.close()  # the crash: everything in memory is gone
    t1 = time.perf_counter()
    rec = PlanningService.recover(jdir, journal_fsync=True, snapshot_every=0, **kw)
    replay_s = time.perf_counter() - t1
    restored = len(rec._responses)
    check(rec.queue_depth == in_flight,
          f"recovery re-enqueued {rec.queue_depth} requests, {in_flight} were in flight")
    t2 = time.perf_counter()
    rec.drain()
    rerun_s = time.perf_counter() - t2
    rids += _paced(rec, requests[SERVICE_KILL_AT:])
    rec.drain()
    wall = time.perf_counter() - t0
    check(rids == list(range(SERVICE_N)), f"request ids after recovery: {rids}")
    resps = [rec.collect(rid) for rid in rids]
    rec.close()
    st = stream_stats(np, requests, resps, [r.latency_seconds for r in resps], wall,
                      offline)
    st.update(in_flight_at_crash=in_flight, responses_restored=restored,
              replay_ms=replay_s * 1e3, rerun_ms=rerun_s * 1e3)
    out["recovered"] = st
    print_stream("recovered", st, f"; a burst of {SERVICE_KILL_AT}, killed with "
                 f"{in_flight} in flight and {restored} answered: WAL replay "
                 f"{replay_s * 1e3:.3f} ms, re-run {rerun_s * 1e3:.3f} ms")

    svc = PlanningService(**dict(kw, max_queue_depth=SERVICE_CHAOS))
    labelled = list(chaos_requests(SERVICE_CHAOS, seed=seed))
    t0 = time.perf_counter()
    rids = [svc.submit(req) for _, req in labelled]
    svc.drain()
    wall = time.perf_counter() - t0
    resps = [svc.collect(rid) for rid in rids]
    st = stream_stats(np, [req for _, req in labelled], resps,
                      [r.latency_seconds for r in resps], wall, {})
    out["chaos"] = st
    print(f"phase service chaos: chaos_requests({SERVICE_CHAOS}, seed={seed}) in "
          f"{wall:.3f} s: 100 % typed responses, outcomes {st['outcomes']}")
    return out


def phase_forward(torch, seed: int):
    """The 224x224 VGG-16 forward through the kernel vs the plain forward.
    Returns the model, its input and the phase's numbers."""
    from repro_torch.kernels import fused_conv, ops
    from repro_torch.models.vgg import VGG16

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = VGG16(in_hw=224, n_classes=1000, device="cuda", generator=gen)
    x = torch.randn((BATCH, 224, 224, 3), generator=gen, device="cuda")
    conv = ops.fused_conv_fn()
    before = fused_conv.fused_conv3x3.launches
    with torch.inference_mode():
        y = model(x, fused_conv_fn=conv)
        torch.cuda.synchronize()
        launched = fused_conv.fused_conv3x3.launches - before
        y_plain = model(x)
    check(launched == 13, f"the forward launched fused_conv3x3 {launched} "
          "times, not 13")
    check(tuple(y.shape) == (BATCH, 1000), f"logits shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite logits")
    err = float((y - y_plain).abs().max())
    scale = float(y_plain.abs().max())
    check(err <= LOGIT_TOL * scale,
          f"fused logits differ from plain by {err} > {LOGIT_TOL} x {scale}")
    print(f"phase forward: VGG-16 224x224 batch {BATCH} float32 through "
          f"fused_conv3x3 ({launched} launches); logits max |fused - plain| "
          f"= {err:.6g} (max |logit| {scale:.6g}, tolerance "
          f"{LOGIT_TOL} x max)")
    return model, x, {"launches": launched, "max_abs_err": err,
                      "max_abs_logit": scale}


def time_forward(torch, model, x) -> dict:
    """Median ms of the forward through the kernel and of the plain one."""
    from repro_torch.kernels import ops

    conv = ops.fused_conv_fn()
    with torch.inference_mode():
        ms = time_ms(torch, {"fused": lambda: model(x, fused_conv_fn=conv),
                             "plain": lambda: model(x)}, REPS)
    print(f"phase forward_time: batch {BATCH}: through fused_conv3x3 "
          f"{ms['fused']:.3f} ms ({BATCH / ms['fused'] * 1e3:.6g} images/s), "
          f"plain {ms['plain']:.3f} ms")
    return ms


def phase_layers(torch, spec, seed: int) -> list:
    """fused_conv3x3 vs its plain version at each VGG-16 conv shape; the
    bound is the larger of the bytes over ``spec``'s memory rate and the
    multiply-adds over its peak for the input type (float32: the CUDA-core
    rate, since the kernel and its plain version run with TF32 off)."""
    import torch.nn.functional as F

    from repro_torch.core.ir import VGG16_CONV_PLAN
    from repro_torch.kernels import fused_conv, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    print(f"phase layers: bounds at {spec.hbm_bw / 1e12:g} TB/s; float32 the "
          f"smaller of FLOPs / {spec.peak_fp32_flops / 1e12:g} TFLOP/s (CUDA "
          f"cores) and 3 x FLOPs / {spec.peak_tf32_flops / 1e12:g} TFLOP/s "
          f"(3xTF32 on the tensor cores); bfloat16 FLOPs / "
          f"{spec.peak_bf16_flops / 1e12:g} TFLOP/s (data sheet, H100 SXM at 700 W)")
    rows = []
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16),
                         (BATCH, torch.float32)):
        dname = str(dtype).removeprefix("torch.")
        for name, cin, cout, hw, pool in VGG16_CONV_PLAN:
            def randn(*shape, std=1.0):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * std).to(dtype)

            x = randn(batch, hw, hw, cin)
            w = randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5)
            b = randn(cout, std=0.1)
            # cuDNN yardstick, timed only: an NCHW view of the NHWC input
            # (channels-last memory, no copy) and OIHW weights.
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()

            def library():
                with ref.no_tf32():
                    y = torch.relu(F.conv2d(x_nchw, w_oihw, b, padding=1))
                    return F.max_pool2d(y, 2) if pool else y

            def kernel():
                return fused_conv.fused_conv3x3(x, w, b, pool=pool)

            def plain():
                return ref.fused_conv3x3_ref(x, w, b, pool=pool)

            want = plain().float()
            got = kernel().float()
            torch.cuda.synchronize()
            tol = TOL[dname]
            err = float((got - want).abs().max())
            check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
                  f"{name} batch {batch} {dname}: kernel differs from plain "
                  f"by up to {err} (tolerance {tol})")
            lib_err = float((library().permute(0, 2, 3, 1).float()
                             - want).abs().max())
            ms, one = time_kernel(torch, {"plain": plain, "kernel": kernel,
                                          "library": library})
            es = x.element_size()
            out_hw = hw // 2 if pool else hw
            n_bytes = es * (x.numel() + w.numel() + b.numel()
                            + batch * out_hw * out_hw * cout)
            flops = 2 * 9 * cin * cout * hw * hw * batch
            t_bytes = spec.memory_seconds(n_bytes) * 1e3
            t_cores, t_3x = conv_op_bounds(spec, flops, es)
            t_ops = t_cores if t_3x is None else min(t_cores, t_3x)
            geo = fused_conv.launch_geometry(batch, hw, hw, cin, cout)
            row = {"layer": name, "batch": batch, "dtype": dname, "hw": hw,
                   "cin": cin, "cout": cout, "pool": pool, "tile": geo.tile,
                   "blocks": geo.grid[0] * geo.grid[1] * geo.grid[2],
                   "bound_cuda_cores_ms": t_cores, "bound_3xtf32_ms": t_3x,
                   "max_abs_err": err, "library_max_abs_err": lib_err,
                   "ms": ms["kernel"], "plain_ms": ms["plain"],
                   "library_ms": ms["library"], "call_ms": one["kernel"],
                   "plain_call_ms": one["plain"], "library_call_ms": one["library"],
                   "bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            rows.append(row)
            bounds = (f"; CUDA cores {t_cores:.4f}, 3xTF32 {t_3x:.4f}"
                      if t_3x is not None else "")
            print(f"layer {name} b{batch} {dname} {hw}x{hw} {cin}->{cout} "
                  f"pool={int(pool)} tile {geo.tile} ({row['blocks']} blocks): "
                  f"kernel {row['ms']:.4f} ms (one call {row['call_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f}"
                  f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}{bounds}; "
                  f"{flops / row['ms'] / 1e9:.4g} TFLOP/s), max_abs_err "
                  f"{err:.3g}")
    return rows


def conv_op_bounds(spec, flops: float, es: int) -> tuple:
    """The operations bound (ms) of a conv: float32 (``es`` 4) gives the
    CUDA-core bound and the 3xTF32 bound (the kernel's float32-exact route
    on the tensor cores); bfloat16 its tensor-core bound and None."""
    if es == 4:
        return spec.compute_seconds(flops, 4) * 1e3, spec.tf32x3_seconds(flops) * 1e3
    return spec.compute_seconds(flops, es) * 1e3, None


# ---------------------------------------------------------------------------
# The transformer serving path: plan, serve, and flash_attention / fused_mlp
# ---------------------------------------------------------------------------


def zero_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import (flash_attention_bwd, fused_attention, fused_conv,
                                     fused_mlp, mamba_scan)

    fused_conv.fused_conv3x3.launches = 0
    fused_attention.flash_attention.launches = 0
    fused_mlp.fused_mlp.launches = 0
    mamba_scan.selective_scan.launches = 0
    flash_attention_bwd.flash_attention_bwd.launches = 0


def read_counts() -> dict:
    """Every kernel's launch count."""
    from repro_torch.kernels import (flash_attention_bwd, fused_attention, fused_conv,
                                     fused_mlp, mamba_scan)

    return {"fused_conv3x3": fused_conv.fused_conv3x3.launches,
            "flash_attention": fused_attention.flash_attention.launches,
            "fused_mlp": fused_mlp.fused_mlp.launches,
            "selective_scan": mamba_scan.selective_scan.launches,
            "flash_attention_bwd": flash_attention_bwd.flash_attention_bwd.launches}


def phase_plan(spec) -> list:
    """plan_model for every registry config at 4096 tokens, against the
    card's own opt-in shared memory; for a config with Mamba layers, the
    selective scan's tile too."""
    from repro_torch.configs import REGISTRY
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels import mamba_scan

    rows = []
    for name, cfg in REGISTRY.items():
        plan = plan_model(cfg, 4096, spec)
        tiles = [("attention", plan.attn_vmem_bytes), ("mlp", plan.mlp_vmem_bytes)]
        scan_smem = None
        if "mamba" in cfg.layer_pattern:
            scan_smem = mamba_scan.smem_bytes(plan.mamba_chunk, plan.mamba_block_d,
                                              cfg.ssm_state)
            tiles.append(("selective_scan", scan_smem))
            check(cfg.ssm_state <= mamba_scan.MAX_DS
                  and plan.mamba_block_d <= mamba_scan.MAX_BLOCK_D,
                  f"{name}: the selective_scan kernel does not take ds "
                  f"{cfg.ssm_state}, block_d {plan.mamba_block_d}")
        for what, n in tiles:
            check(0 <= n <= spec.smem_per_block_optin,
                  f"{name}: the {what} tile stages {n} bytes, more than the "
                  f"card's {spec.smem_per_block_optin}")
        check(plan.use_flash or "attn" not in "".join(cfg.layer_pattern),
              f"{name}: no flash_attention tile for an attention model")
        rows.append({"arch": name, "attn_tile": [plan.attn_block_q, plan.attn_block_k],
                     "attn_smem": plan.attn_vmem_bytes,
                     "mlp_tile": [plan.mlp_block_m, plan.mlp_block_f],
                     "mlp_smem": plan.mlp_vmem_bytes,
                     "scan_tile": [plan.mamba_chunk, plan.mamba_block_d],
                     "scan_smem": scan_smem, "bw_saving": plan.bw_saving,
                     "engine": plan.search_engine})
        scan = "" if scan_smem is None else (
            f"; selective_scan tile {plan.mamba_chunk}x{plan.mamba_block_d}, "
            f"{scan_smem} B shared")
        print(f"plan {plan.describe()} [{plan.search_engine}]{scan}")
    print(f"phase plan: {len(rows)} configs, every tile within "
          f"{spec.smem_per_block_optin} bytes of shared memory")
    return rows


def serve_argv(run: dict, seed: int) -> list:
    """A serving run's command line."""
    return ["--arch", run["arch"], "--full", "--requests", str(run["requests"]),
            "--prompt-len", str(run["prompt_len"]), "--gen", str(run["gen"]),
            "--seed", str(seed)]


def serve_config(run: dict):
    """A serving run's config at full width: the registry's, its depth cut
    to ``run["n_layers"]`` where the run says so."""
    import dataclasses

    from repro_torch.configs import resolve

    cfg = resolve(run["arch"])
    if "n_layers" in run:
        cfg = dataclasses.replace(cfg, n_layers=run["n_layers"])
    return cfg


def serve_rc(cfg, run: dict, **overrides):
    """The run configuration of a serving run: ``serve.main``'s attention
    block (its other overrides reach no serving path on the card)."""
    import dataclasses

    from repro_torch.configs import run_config

    return dataclasses.replace(run_config(cfg.name, "decode_32k"),
                               attn_chunk_kv=min(64, run["prompt_len"]), **overrides)


def depth_of(cfg, of_layers: int | None = None) -> str:
    """The layers a run holds, and the cut if it holds fewer."""
    if cfg.is_encoder_decoder:
        return f"{cfg.n_enc_layers} + {cfg.n_layers} layers"
    if of_layers in (None, cfg.n_layers):
        return f"{cfg.n_layers} layers"
    return f"{cfg.n_layers} of {of_layers} layers (depth cut), full width"


def phase_serve(np, run: dict, seed: int, phase: str = "serve") -> dict:
    """The port's serve entry point at full width: ``serve.main`` at full
    depth, or ``serve.run`` (the same prefill and decode steps) on the
    config cut to ``run["n_layers"]``."""
    from repro_torch.configs import resolve
    from repro_torch.launch import serve

    full = resolve(run["arch"])
    cfg = serve_config(run)
    t0 = time.perf_counter()
    if cfg.n_layers == full.n_layers:
        ids = serve.main(serve_argv(run, seed))
    else:
        ids = serve.run(cfg, serve_rc(cfg, run), requests=run["requests"],
                        prompt_len=run["prompt_len"], gen=run["gen"], seed=seed)["ids"]
    wall = time.perf_counter() - t0
    check(ids.shape == (run["requests"], run["gen"]),
          f"serve returned ids of shape {ids.shape}")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          "token ids outside the vocabulary")
    frames = f" + {cfg.frontend_len} frames" if cfg.frontend else ""
    print(f"phase {phase}: {cfg.name} at {depth_of(cfg, full.n_layers)}, bfloat16 "
          f"({cfg.param_counts()['total'] * 2 / 1e9:.4g} GB of weights), "
          f"{run['requests']} requests x prompt {run['prompt_len']}{frames} + "
          f"{run['gen']} generated tokens in {wall:.3f} s (first call, "
          f"kernels loaded); {np.unique(ids).size} distinct ids")
    return {"wall_s": wall, "ids_head": ids[0][:12].tolist(), "n_layers": cfg.n_layers}


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 0):
    """The plain attention reordered, with no kernel: online softmax over
    blocks of CONTROL_KV_BLOCK keys in float32 (the reference's
    attention_chunked order), the result in ``q.dtype``."""
    import math

    import torch

    from repro_torch.models.layers import NEG_INF

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    idx = torch.arange(H, device=q.device) // (H // KV)
    qf = q.float().transpose(1, 2)  # (B, H, Sq, hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, hd), device=q.device)
    for c0 in range(0, Skv, CONTROL_KV_BLOCK):
        kb = k[:, c0:c0 + CONTROL_KV_BLOCK].index_select(2, idx).float().transpose(1, 2)
        vb = v[:, c0:c0 + CONTROL_KV_BLOCK].index_select(2, idx).float().transpose(1, 2)
        s = (qf @ kb.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        kp = torch.arange(c0, c0 + kb.shape[2], device=q.device)[None, :]
        ok = (kp <= qp) if causal else torch.ones_like(kp <= qp)
        if window:
            ok = ok & ((qp - kp) < window)
            if not causal:
                ok = ok & ((kp - qp) < window)
        elif chunk:
            ok = ok & ((qp // chunk) == (kp // chunk))
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def scan_control(rc):
    """falcon-mamba's reordering: the plain path with the reference's
    chunk-recurrent scan in place of the sequential one."""
    import dataclasses
    import functools

    from repro_torch.kernels import ops
    from repro_torch.models import ssm as SSM

    return dataclasses.replace(ops.PLAIN, ssm_scan=functools.partial(
        SSM.selective_scan_chunked, chunk=rc.mamba_chunk))


def attention_control(rc):
    """The MoE and encoder-decoder serves' reordering: the plain path with
    :func:`blocked_attention` for the attention."""
    import dataclasses

    from repro_torch.kernels import ops

    return dataclasses.replace(ops.PLAIN, attention=blocked_attention)


def route_flips(run_a, run_b) -> tuple:
    """([token routes whose top-k expert set differs between ``run_a()``
    and ``run_b()``, one count per MoE layer], routes in all): each run's
    routing is recorded from ``moe.route_topk``."""
    from repro_torch.models import moe as MOE

    real = MOE.route_topk

    def recorded(run):
        seen = []

        def route(logits, top_k):
            gates, idx, probs = real(logits, top_k)
            seen.append(idx.sort(dim=-1).values)
            return gates, idx, probs

        MOE.route_topk = route
        try:
            run()
        finally:
            MOE.route_topk = real
        return seen

    a, b = recorded(run_a), recorded(run_b)
    per_layer = [int((x != y).any(dim=-1).sum()) for x, y in zip(a, b)]
    return per_layer, sum(x[..., 0].numel() for x in a)


def serve_batch(torch, cfg, B: int, S: int, gen):
    """Random prompts (and, for a model with a frontend, its frames)."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    if cfg.frontend:
        batch["frontend"] = torch.randn((B, cfg.frontend_len, cfg.d_model), generator=gen,
                                        device="cuda").to(getattr(torch, cfg.dtype))
    return batch


def phase_serve_time(torch, run: dict, seed: int, tols: dict,
                     f32_layers: int | None = None, phase: str = "serve_time",
                     control=None) -> dict:
    """Prefill and decode through the kernels and through their plain
    versions (in turns), a profiled prefill and four decode steps, and the
    prefill logits of the two held together in bfloat16 (the run's depth)
    and float32 (``f32_layers`` layers at full width; ``None``: the run's
    depth) within ``tols``.  ``control(rc)``: a kernel-free reordering of
    the plain path (FusedKernels); the bfloat16 logits may then also differ
    by CONTROL_FACTOR times what it moves them by."""
    import dataclasses

    from repro_torch.configs import resolve
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    full_depth = resolve(run["arch"]).n_layers
    cfg = serve_config(run)
    rc = serve_rc(cfg, run)
    B, S, n_gen = run["requests"], run["prompt_len"], run["gen"]
    max_seq = S + n_gen + 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = M.init_params(cfg, generator=gen)
    batch = serve_batch(torch, cfg, B, S, gen)
    paths = {"kernels": ops.KERNELS, "plain": ops.PLAIN}
    out = {}

    def prefill(p, c, name):
        cache = M.init_cache(c, B, max_seq)
        kernels = control(rc) if name == "control" else paths[name]
        return M.prefill(p, c, rc, batch, cache, kernels=kernels)

    def control_err(p, c, want):
        """max |logits| difference of the reordered plain path from ``want``."""
        if control is None:
            return None
        return float((prefill(p, c, "control")[0] - want).abs().max())

    with torch.inference_mode():
        first = {name: prefill(params, cfg, name) for name in paths}
        samples = {f"{name}_{what}": [] for name in paths
                   for what in ("prefill", "decode")}
        for _ in range(3):
            for name in ("kernels", "plain", "plain", "kernels"):
                ms, (logits, cache) = event_ms(torch, lambda: prefill(params, cfg, name))
                samples[f"{name}_prefill"].append(ms)
                tok = logits[:, -1].argmax(-1)[:, None]

                def decode_all(tok=tok, cache=cache, name=name):
                    for _ in range(n_gen - 1):
                        lg, c = M.decode(params, cfg, rc, tok, cache, kernels=paths[name])
                        cache = c
                        tok = lg[:, -1].argmax(-1)[:, None]
                    return tok

                ms, _ = event_ms(torch, decode_all)
                samples[f"{name}_decode"].append(ms / (n_gen - 1))
                del logits, cache
        med = {k: statistics.median(v) for k, v in samples.items()}
        for name in paths:
            pre, dec = med[f"{name}_prefill"], med[f"{name}_decode"]
            out[name] = {"prefill_ms": pre, "decode_ms_per_token": dec,
                         "decode_tokens_per_s": B / dec * 1e3,
                         "tokens_per_s": B * n_gen / (pre + (n_gen - 1) * dec) * 1e3}
            print(f"phase {phase}: through the {name:7s}: prefill {pre:.3f} ms, "
                  f"decode {dec:.3f} ms/token ({out[name]['decode_tokens_per_s']:.6g} "
                  f"tokens/s), {out[name]['tokens_per_s']:.6g} tokens/s end to end "
                  f"({B} requests x {n_gen} tokens)")
        out["trace"] = _serve_trace(torch, lambda: prefill(params, cfg, "kernels"),
                                    lambda lg, c: M.decode(params, cfg, rc,
                                                           lg[:, -1].argmax(-1)[:, None],
                                                           c, kernels=paths["kernels"]),
                                    phase)
        out["logits"] = {}
        lk, lp = first["kernels"][0], first["plain"][0]
        del first
        out["logits"]["bfloat16"] = _logits_agree(
            torch, "bfloat16", lk, lp, tols, phase, depth_of(cfg, full_depth),
            control=control_err(params, cfg, lp))
        if cfg.n_experts:
            flips, routes = route_flips(lambda: prefill(params, cfg, "kernels"),
                                        lambda: prefill(params, cfg, "plain"))
            out["logits"]["bfloat16"]["routes_flipped"] = {"per_layer": flips,
                                                           "routes": routes}
            print(f"phase {phase}: bfloat16 prefill, kernels vs plain: {sum(flips)} of "
                  f"{routes} token routes ({len(flips)} MoE layers) chose another "
                  f"top-{cfg.top_k} expert set; by layer {flips}")
        del params
        torch.cuda.empty_cache()
        n32 = cfg.n_layers if f32_layers is None else f32_layers
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n32)
        gen = torch.Generator(device="cuda").manual_seed(seed + 3)
        params32 = M.init_params(cfg32, generator=gen)
        lk = prefill(params32, cfg32, "kernels")[0]
        lp = prefill(params32, cfg32, "plain")[0]
        out["logits"]["float32"] = _logits_agree(
            torch, "float32", lk, lp, tols, phase, depth_of(cfg32, full_depth),
            control=control_err(params32, cfg32, lp))
        del params32
        torch.cuda.empty_cache()
    return out


def phase_serve_ring(torch, run: dict, seed: int) -> dict:
    """Serve through runtime.steps with ``local_ring_cache`` and a ring
    cache (the tenth main path: the caller zeroes the counts before and
    reads them after ``out["ring"]``'s run), then the same tokens through
    the full cache: the prefill's and each decode step's logits within
    RING_TOL x the largest logit, the rings window-sized."""
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    from repro_torch.configs import resolve

    full_depth = resolve(run["arch"]).n_layers
    cfg = serve_config(run)
    B, S, n_gen = run["requests"], run["prompt_len"], run["gen"]
    max_seq = S + n_gen + 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    params = M.init_params(cfg, generator=gen)
    batch = serve_batch(torch, cfg, B, S, gen)
    out, logits, tokens = {}, {}, []

    with torch.inference_mode():
        for name, ring in (("ring", True), ("full", False)):
            rc = serve_rc(cfg, run, local_ring_cache=ring)
            prefill, decode = make_prefill_step(cfg, rc), make_decode_step(cfg, rc)
            cache = M.init_cache(cfg, B, max_seq, ring=ring)
            n_bytes = sum(t.numel() * t.element_size() for seg in cache["segments"]
                          for layer in seg for sub in layer.values() for t in sub.values())
            entries = sorted({sub["k"].shape[1] for seg in cache["segments"]
                              for layer in seg for sub in layer.values()})
            if ring:
                check(entries == sorted({min(max_seq, cfg.window_size), max_seq}),
                      f"the ring cache holds {entries} entries a layer, not "
                      f"{cfg.window_size} (local) and {max_seq} (global)")
            pre_ms, (lg, cache) = event_ms(torch, lambda: prefill(params, cache, batch))
            steps, step_ms = [lg], []
            for i in range(n_gen - 1):
                if ring:
                    tokens.append(lg[:, -1].argmax(-1)[:, None])
                tok = tokens[i]  # the full cache is fed the ring run's tokens
                ms, (lg, cache) = event_ms(torch, lambda: decode(params, cache, tok))
                step_ms.append(ms)
                steps.append(lg)
            logits[name] = torch.cat(steps, dim=1)
            out[name] = {"prefill_ms": pre_ms,
                         "decode_ms_per_token": statistics.median(step_ms),
                         "decode_ms_mean": statistics.mean(step_ms),
                         "cache_bytes": n_bytes, "entries": entries}
            print(f"phase serve_ring: {cfg.name} at {depth_of(cfg, full_depth)}, "
                  f"{'ring' if ring else 'full'} cache ({entries} entries a layer, "
                  f"{n_bytes} bytes): prefill {pre_ms:.3f} ms, decode "
                  f"{out[name]['decode_ms_per_token']:.3f} ms/token (the median step "
                  f"between two events; mean {out[name]['decode_ms_mean']:.3f}), "
                  f"{B} requests x prompt {S} + {n_gen} tokens")
            if ring:
                out["ring_counts"] = read_counts()
            del cache, lg, steps
        ring_l, full_l = logits["ring"], logits["full"]
        check(bool(torch.isfinite(ring_l).all()), "non-finite logits through the ring")
        pre_err = float((ring_l[:, 0] - full_l[:, 0]).abs().max())
        err = float((ring_l - full_l).abs().max())
        scale = float(full_l.abs().max())
        check(err <= RING_TOL * scale,
              f"logits through the ring differ from the full cache by "
              f"{err} > {RING_TOL} x {scale}")
        same = float((ring_l.argmax(-1) == full_l.argmax(-1)).float().mean())
        print(f"phase serve_ring: logits ring vs full cache, the prefill and "
              f"{n_gen - 1} decode steps: max |diff| {err:.6g} (the prefill's "
              f"{pre_err:.6g}; max |logit| {scale:.6g}, allowed {RING_TOL * scale:.6g}: "
              f"{RING_TOL} x max); argmax agrees on {same:.4f} of the (request, step) "
              f"pairs; cache bytes ring {out['ring']['cache_bytes']} vs full "
              f"{out['full']['cache_bytes']}")
        out["logits"] = {"max_abs_err": err, "prefill_max_abs_err": pre_err,
                         "max_abs_logit": scale, "allowed": RING_TOL * scale,
                         "argmax_agree": same}
        del params, logits, ring_l, full_l
        torch.cuda.empty_cache()
    return out


def _device_busy(torch, fn, watch: tuple = ()) -> dict:
    """Host wall ms of ``fn()`` (synchronised), the ms the device was busy
    in it (the union of its kernel, copy and set intervals, from the
    profiler), the largest device times by name and the device times of the
    names that contain one of ``watch``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of intervals, in microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:50]] = by_name.get(e.name[:50], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall if spans else None,
            "kernels_launched": len(spans), "top_device_ms": top,
            "watched_device_ms": {n: t for n, t in by_name.items()
                                  if any(w in n for w in watch)}}


def _serve_trace(torch, prefill, decode, phase: str) -> dict:
    """One profiled prefill and four profiled decode steps through the
    kernels: how much of the wall time the device was busy."""
    holder = {}

    def run_prefill():
        holder["logits"], holder["cache"] = prefill()

    def run_decode():
        for _ in range(4):
            holder["logits"], holder["cache"] = decode(holder["logits"], holder["cache"])

    out = {"prefill": _device_busy(torch, run_prefill),
           "decode_4_steps": _device_busy(torch, run_decode)}
    for what, r in out.items():
        idle = r["device_idle_share"]
        print(f"phase {phase} trace: {what} through the kernels: wall {r['wall_ms']:.3f} "
              f"ms, device busy {r['device_busy_ms']:.3f} ms, device idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}, "
              f"{r['kernels_launched']} device operations; largest: "
              + "; ".join(f"{n} {t:.3f} ms" for n, t in r["top_device_ms"]))
    return out


def _logits_agree(torch, dname: str, got, want, tols: dict, phase: str,
                  depth: str, *, control: float | None = None) -> dict:
    """Check prefill logits through the kernels against the plain path,
    within ``tols[dname]`` x the largest logit or, in bfloat16 where
    ``control`` (the kernel-free reordering's max |diff|) is given,
    CONTROL_FACTOR x ``control`` if that is larger."""
    check(bool(torch.isfinite(got).all()), f"non-finite {dname} prefill logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = tols[dname]
    allowed = tol * scale
    rule = f"{tol} x max"
    if control is not None and dname == "bfloat16":
        allowed = max(allowed, CONTROL_FACTOR * control)
        rule += f" or {CONTROL_FACTOR} x the reordering's, if larger"
    check(err <= allowed, f"{phase}: {dname} prefill logits through the kernels "
          f"differ from plain by {err} > {allowed} ({rule})")
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ctl = "" if control is None else (
        f"; the plain path reordered (no kernel) vs plain: max |diff| {control:.6g}")
    print(f"phase {phase}: {dname} prefill logits at {depth}, kernels vs plain: "
          f"max |diff| {err:.6g} (max |logit| {scale:.6g}, allowed {allowed:.6g}: "
          f"{rule}){ctl}; argmax agrees on {same:.3f} of the requests")
    return {"max_abs_err": err, "max_abs_logit": scale, "allowed": allowed,
            "control_max_abs_err": control, "argmax_agree": same, "depth": depth}


_SDPA_NAMES: dict = {}


def sdpa_kernel_names(torch, fn, key) -> str:
    """The CUDA kernels one call of ``fn`` ran, from the profiler (the
    yardstick's backend), or "not measured" if it shows none."""
    if key not in _SDPA_NAMES:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if getattr(e, "device_time_total", 0) > 0
                        and "elementwise" not in e.key.lower()})
        _SDPA_NAMES[key] = "; ".join(n[:60] for n in names) or "not measured"
    return _SDPA_NAMES[key]


def _visible_pairs(Sq, Skv, causal, window, chunk) -> int:
    """(query, key) pairs the masks leave visible (the work a run needs)."""
    import torch

    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
        if not causal:
            ok &= (kp - qp) < window
    elif chunk:
        ok &= (qp // chunk) == (kp // chunk)
    return int(ok.sum())


def tile_sweep(torch, what: str, run, want, tiles, tol: float, flops: int) -> list:
    """``run(tile)`` at every built tile, each held to ``want`` within
    ``tol`` (atol = rtol) and timed per launch: which tile is fastest at a
    main-path shape (the wrapper's default is chosen from these rows)."""
    rows = []
    for tile in tiles:
        got = run(tile).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
              f"{what} tile {tile[0]}x{tile[1]}: differs from plain by up to {err}")
        ms = time_ms(torch, {"kernel": lambda: run(tile)}, REPS, CALLS)["kernel"]
        rows.append({"case": what, "tile": list(tile), "ms": ms, "max_abs_err": err})
        print(f"tiles {what} {tile[0]}x{tile[1]}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.4g} TFLOP/s), max_abs_err {err:.3g}")
    return rows


def phase_attention(torch, spec, seed: int, plan_tile) -> list:
    """flash_attention vs its plain version; yardstick: PyTorch's
    scaled_dot_product_attention (GQA, causal or with a boolean mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    serve_shape = (SERVE["requests"], SERVE["prompt_len"], SERVE["prompt_len"],
                   16, 8, 128)
    cases = [  # (label, (B, Sq, Skv, H, KV, hd), dtype, causal, window, chunk, tile)
        ("serve", serve_shape, "bfloat16", True, 0, 0, None),
        ("serve", serve_shape, "float32", True, 0, 0, None),
        ("serve_plan_tile", serve_shape, "bfloat16", True, 0, 0, plan_tile),
    ]
    cases += [(label, shape, "bfloat16", causal, window, 0, None)
              for label, shape, causal, window in SERVE_ATTENTION]
    for shape in ((1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
                  (1, 128, 256, 4, 1, 128), (2, 384, 384, 6, 2, 32)):
        for dname in ("float32", "bfloat16"):
            cases.append(("test_kernels", shape, dname, True, 0, 0, None))
    for window, chunk in ((64, 0), (0, 128), (32, 0)):
        for dname in ("float32", "bfloat16"):
            cases.append(("mask", (2, 256, 256, 4, 2, 64), dname, True, window,
                          chunk, None))
    rows = []
    for label, shape, dname, causal, window, chunk, tile in cases:
        B, Sq, Skv, H, KV, hd = shape
        dtype = getattr(torch, dname)
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
        bq, bk = tile if tile else fused_attention.DEFAULT_TILE
        mask = dict(causal=causal, window=window, chunk=chunk)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window or chunk:
            qp = torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Skv, device="cuda")[None, :]
            allowed = (kp <= qp) if causal else torch.ones_like(kp <= qp)
            if window:
                allowed &= (qp - kp) < window
                if not causal:
                    allowed &= (kp - qp) < window
            else:
                allowed &= (qp // chunk) == (kp // chunk)
            lib_kw = dict(attn_mask=allowed)
        else:
            lib_kw = dict(is_causal=causal)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw)

        def kernel():
            return fused_attention.flash_attention(q, k, v, block_q=bq, block_k=bk, **mask)

        def plain():
            return ref.flash_attention_ref(q, k, v, **mask)

        want = plain().float()
        got = kernel().float()
        torch.cuda.synchronize()
        tol = ATT_TOL[dname]
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
              f"flash_attention {label} {shape} {dname} {mask} tile {bq}x{bk}: "
              f"differs from plain by up to {err} (tolerance {tol})")
        lib_err = float((library().transpose(1, 2).float() - want).abs().max())
        backend = sdpa_kernel_names(torch, library, (dname, bool(window or chunk)))
        ms, one = time_kernel(torch, {"plain": plain, "kernel": kernel, "library": library})
        es = q.element_size()
        n_bytes = es * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * B * H * hd * _visible_pairs(Sq, Skv, causal, window, chunk)
        t_bytes = spec.memory_seconds(n_bytes) * 1e3
        t_ops = spec.compute_seconds(flops, es) * 1e3
        row = {"case": label, "shape": list(shape), "dtype": dname, **mask,
               "tile": [bq, bk], "max_abs_err": err, "library_max_abs_err": lib_err,
               "library_backend": backend, "ms": ms["kernel"],
               "plain_ms": ms["plain"], "library_ms": ms["library"],
               "call_ms": one["kernel"], "plain_call_ms": one["plain"],
               "library_call_ms": one["library"], "bytes": n_bytes, "flops": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rows.append(row)
        print(f"attention {label} {shape} {dname} causal={int(causal)} w={window} "
              f"c={chunk} tile {bq}x{bk}: kernel {row['ms']:.4f} ms (one call "
              f"{row['call_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
              f"[{backend}], bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{flops / row['ms'] / 1e9:.4g} TFLOP/s), max_abs_err {err:.3g}")
    B, S, H, KV, hd = serve_shape[0], serve_shape[1], 16, 8, 128
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    rows += tile_sweep(
        torch, "attention serve bfloat16",
        lambda t: fused_attention.flash_attention(q, k, v, block_q=t[0], block_k=t[1]),
        ref.flash_attention_ref(q, k, v).float(), fused_attention.TILES,
        ATT_TOL["bfloat16"], 4 * B * H * hd * _visible_pairs(S, S, True, 0, 0))
    return rows


def phase_mlp(torch, spec, seed: int, plan_tile) -> list:
    """fused_mlp vs its plain version; yardstick: the same three matrix
    products and activation as separate cuBLAS / PyTorch calls in the
    input's dtype."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_mlp, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    T_pre = SERVE["requests"] * SERVE["prompt_len"]
    cases = [  # (label, (T, d, ff, act), dtype, tile)
        ("serve_prefill", (T_pre, 1024, 3072, "swiglu"), "bfloat16", None),
        ("serve_decode", (SERVE["requests"], 1024, 3072, "swiglu"), "bfloat16", None),
        ("serve_prefill", (T_pre, 1024, 3072, "swiglu"), "float32", None),
        ("serve_decode", (SERVE["requests"], 1024, 3072, "swiglu"), "float32", None),
        ("serve_plan_tile", (T_pre, 1024, 3072, "swiglu"), "bfloat16", plan_tile),
        ("decode_one_row", (1, 1024, 3072, "swiglu"), "bfloat16", None),
    ]
    cases += [(label, shape, "bfloat16", None) for label, shape in SERVE_MLP]
    for shape in ((128, 64, 256, "swiglu"), (256, 128, 512, "geglu"),
                  (128, 64, 128, "gelu"), (384, 96, 384, "relu")):
        for dname in ("float32", "bfloat16"):
            cases.append(("test_kernels", shape, dname, None))
    acts = {"swiglu": F.silu, "geglu": lambda h: F.gelu(h, approximate="tanh"),
            "gelu": lambda h: F.gelu(h, approximate="tanh"), "relu": torch.relu}
    rows = []
    for label, (T, d, ff, act), dname, tile in cases:
        dtype = getattr(torch, dname)
        x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
        w1 = (torch.randn((d, ff), generator=gen, device="cuda") * d ** -0.5).to(dtype)
        w3 = (torch.randn((d, ff), generator=gen, device="cuda") * d ** -0.5).to(dtype)
        w2 = (torch.randn((ff, d), generator=gen, device="cuda") * ff ** -0.5).to(dtype)
        gated = act in fused_mlp.GATED
        bm, bf = tile if tile else fused_mlp.default_tile(T, dtype)

        def library():
            h = acts[act](x @ w1)
            return (h * (x @ w3) if gated else h) @ w2

        def kernel():
            return fused_mlp.fused_mlp(x, w1, w2, w3, act=act, block_m=bm, block_f=bf)

        def plain():
            return ref.fused_mlp_ref(x, w1, w2, w3, act=act)

        want = plain().float()
        got = kernel().float()
        torch.cuda.synchronize()
        tol = MLP_TOL[dname]
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
              f"fused_mlp {label} ({T}, {d}, {ff}, {act}) {dname} tile {bm}x{bf}: "
              f"differs from plain by up to {err} (tolerance {tol})")
        lib_err = float((library().float() - want).abs().max())
        ms, one = time_kernel(torch, {"plain": plain, "kernel": kernel, "library": library})
        es = x.element_size()
        n_w = (3 if gated else 2) * d * ff
        n_bytes = es * (2 * T * d + n_w)
        flops = 2 * T * d * ff * (2 if gated else 1) + 2 * T * ff * d
        t_bytes = spec.memory_seconds(n_bytes) * 1e3
        t_ops = spec.compute_seconds(flops, es) * 1e3
        row = {"case": label, "shape": [T, d, ff], "act": act, "dtype": dname,
               "tile": [bm, bf], "max_abs_err": err, "library_max_abs_err": lib_err,
               "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
               "call_ms": one["kernel"], "plain_call_ms": one["plain"],
               "library_call_ms": one["library"], "bytes": n_bytes, "flops": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rows.append(row)
        print(f"mlp {label} T={T} d={d} ff={ff} {act} {dname} tile {bm}x{bf}: kernel "
              f"{row['ms']:.4f} ms (one call {row['call_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{flops / row['ms'] / 1e9:.4g} TFLOP/s), max_abs_err {err:.3g}")
    d, ff = 1024, 3072
    w1, w3 = ((torch.randn((d, ff), generator=gen, device="cuda") * d ** -0.5)
              .to(torch.bfloat16) for _ in range(2))
    w2 = (torch.randn((ff, d), generator=gen, device="cuda") * ff ** -0.5).to(torch.bfloat16)
    for label, T in (("prefill", T_pre), ("decode", SERVE["requests"])):
        x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
        rows += tile_sweep(
            torch, f"mlp serve_{label} bfloat16",
            lambda t: fused_mlp.fused_mlp(x, w1, w2, w3, block_m=t[0], block_f=t[1]),
            ref.fused_mlp_ref(x, w1, w2, w3).float(), fused_mlp.TILES,
            MLP_TOL["bfloat16"], 6 * T * d * ff)
    return rows


SCAN_LIBRARY = "none: no single PyTorch call computes a selective scan"


def phase_scan(torch, spec, seed: int) -> list:
    """selective_scan vs its plain version at the serve shapes (with the
    initial state in and the final state out, as serving calls it), the
    shapes of tests/test_kernels.py (neither: the TPU kernel's function)
    and ragged ones.  No PyTorch call computes the same function, so there
    is no library time."""
    from repro_torch.configs import resolve
    from repro_torch.kernels import mamba_scan, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    cfg = resolve(SERVE_SSM["arch"])
    B, S, di, ds = SERVE_SSM["requests"], SERVE_SSM["prompt_len"], cfg.d_inner, cfg.ssm_state
    cases = [  # (label, (B, S, di, ds), (chunk, block_d) or None, with state)
        ("serve_prefill", (B, S, di, ds), None, True),
        ("serve_decode", (B, 1, di, ds), None, True),
        ("test_kernels", (1, 64, 16, 4), (16, 16), False),
        ("test_kernels", (2, 128, 32, 8), (32, 16), False),
        ("test_kernels", (1, 64, 64, 16), (64, 32), False),
        ("ragged", (3, 200, 1000, 16), (64, 384), True),
        ("ragged", (2, 77, 300, 5), None, True),
    ]
    rows = []
    for label, (b, s, di, ds), tile, state in cases:
        dA = 0.3 + 0.68 * torch.rand((b, s, di, ds), generator=gen, device="cuda")
        dBx = 0.1 * torch.randn((b, s, di, ds), generator=gen, device="cuda")
        C = torch.randn((b, s, ds), generator=gen, device="cuda")
        h0 = 0.5 * torch.randn((b, di, ds), generator=gen, device="cuda") if state else None
        chunk, block_d = tile if tile else mamba_scan.default_tile(di)

        def kernel():
            return mamba_scan.selective_scan(dA, dBx, C, h0, final_state=state,
                                             chunk=chunk, block_d=block_d)

        def plain():
            return ref.selective_scan_ref(dA, dBx, C, h0)

        want_y, want_h = plain()
        got_y, got_h = kernel()
        torch.cuda.synchronize()
        pairs = [(got_y, want_y)] + ([(got_h, want_h)] if state else [])
        err = max(float((g - w).abs().max()) for g, w in pairs)
        check(all(bool(((g - w).abs() <= SCAN_TOL + SCAN_TOL * w.abs()).all())
                  for g, w in pairs),
              f"selective_scan {label} {(b, s, di, ds)} tile {chunk}x{block_d}: "
              f"differs from plain by up to {err} (tolerance {SCAN_TOL})")
        del want_y, want_h, got_y, got_h
        ms, one = time_kernel(torch, {"plain": plain, "kernel": kernel})
        device_ms = graph_ms(torch, kernel) if label == "serve_decode" else None
        n_state = b * di * ds
        n_bytes = 4 * (2 * b * s * di * ds + b * s * ds + b * s * di
                       + (2 * n_state if state else 0))
        flops = 4 * b * s * di * ds  # an FMA for h and one for y
        t_bytes = spec.memory_seconds(n_bytes) * 1e3
        t_ops = spec.compute_seconds(flops, 4) * 1e3
        row = {"case": label, "shape": [b, s, di, ds], "dtype": "float32",
               "tile": [chunk, block_d], "state": state, "max_abs_err": err,
               "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": None,
               "call_ms": one["kernel"], "plain_call_ms": one["plain"],
               "device_ms": device_ms, "library": SCAN_LIBRARY,
               "bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rows.append(row)
        graphed = "" if device_ms is None else f", from a CUDA graph {device_ms:.4f}"
        print(f"scan {label} {(b, s, di, ds)} tile {chunk}x{block_d} state={int(state)}: "
              f"kernel {row['ms']:.4f} ms (one call {row['call_ms']:.4f}{graphed}), "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{SCAN_LIBRARY}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{n_bytes / row['ms'] / 1e9:.4g} TB/s), max_abs_err {err:.3g}")
        del dA, dBx, C, h0
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The training path: qwen3-0.6b through launch.train, and the attention
# backward kernel
# ---------------------------------------------------------------------------


def train_rc(cfg, **overrides):
    """The training run's configuration: train_4k's run config with the
    run's microbatches, "full" remat, the custom-VJP flash attention and
    launch.train's warmup."""
    from repro_torch.configs import run_config

    return run_config(cfg.name, "train_4k", microbatches=TRAIN_RUN["microbatches"],
                      remat="full", flash_vjp=True,
                      warmup_steps=max(TRAIN_RUN["steps"] // 10, 1), **overrides)


def train_model_flops(cfg, tokens: int, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 N D (N every parameter, the tied
    head's product included) plus the attention's products, 4 per visible
    pair and head dim forward and 8 backward, at ``batch`` sequences of
    ``seq``; the remat recompute is not counted."""
    n = cfg.param_counts()["total"]
    pairs = _visible_pairs(seq, seq, True, 0, 0)
    attn = 12 * cfg.n_layers * batch * cfg.n_heads * cfg.resolved_head_dim * pairs
    return 6.0 * n * tokens + attn


def phase_train(torch, seed: int, tmp: Path) -> dict:
    """The port's training entry point at full width and depth:
    ``launch.train.run`` (``main``'s trainer, data and checkpoints) on
    qwen3-0.6b with TRAIN_RUN's batch, steps, checkpoint and failure."""
    import math

    from repro_torch.configs import resolve
    from repro_torch.launch import train

    cfg = resolve(TRAIN_RUN["arch"])
    rc = train_rc(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train.run(cfg, rc, steps=TRAIN_RUN["steps"], batch=TRAIN_RUN["batch"],
                    seq=TRAIN_RUN["seq"], ckpt_dir=tmp, ckpt_every=TRAIN_RUN["ckpt_every"],
                    inject_failures=(TRAIN_RUN["fail_at"],), seed=seed, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    r = out["report"]
    losses = r.losses
    fail, every = TRAIN_RUN["fail_at"], TRAIN_RUN["ckpt_every"]
    restored = fail // every * every - 1  # the last checkpointed step before the failure
    replayed = list(range(restored + 1, fail))
    check(r.failures == 1 and r.restores == 1,
          f"training saw {r.failures} failures and {r.restores} restores, not 1 and 1")
    check(r.steps_run == TRAIN_RUN["steps"] + len(replayed),
          f"training ran {r.steps_run} steps, not {TRAIN_RUN['steps']} + "
          f"{len(replayed)} replayed")
    check(all(math.isfinite(x) for x in losses), f"non-finite training losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    replay = []
    for i, step in enumerate(replayed):
        first, again = losses[step], losses[fail + i]
        rel = abs(again - first) / abs(first)
        replay.append({"step": step, "first": first, "replayed": again,
                       "bit_equal": first == again, "rel_diff": rel})
        if first == again:
            print(f"phase train: step {step} replayed from the step-{restored} "
                  f"checkpoint: loss {again!r}, bit-equal to the first pass")
            continue
        check(i > 0, f"step {step}, the first replayed from the restored checkpoint, "
              f"gave loss {again!r}, not the first pass's {first!r}")
        check(rel <= REPLAY_TOL, f"replayed step {step}: loss {again!r} against "
              f"{first!r} (relative {rel:.3g} > {REPLAY_TOL})")
        print(f"phase train: step {step} replayed: loss {again!r} against the first "
              f"pass's {first!r}, relative {rel:.3g} (<= {REPLAY_TOL}): not bit-equal; "
              "cause: its parameters come from the replayed step "
              f"{step - 1}'s update, whose gradient sums the card took in another order")
    tokens = TRAIN_RUN["batch"] * TRAIN_RUN["seq"]
    print(f"phase train: {cfg.name} at {depth_of(cfg)}, bfloat16, {out['n_params']:,} "
          f"parameters; {TRAIN_RUN['steps']} steps of {TRAIN_RUN['batch']} x "
          f"{TRAIN_RUN['seq']} tokens ({TRAIN_RUN['microbatches']} microbatches, remat "
          f"{rc.remat}, flash_vjp) + {len(replayed)} replayed in {out['seconds']:.3f} s "
          f"(checkpoint, failure and restore included); losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; failures {r.failures}, restores {r.restores}, stragglers {r.stragglers}, "
          f"redispatches {r.redispatches}; peak device memory {peak / 2**30:.3f} GiB")
    return {"losses": losses, "replay": replay, "seconds": out["seconds"],
            "steps_run": r.steps_run, "redispatches": r.redispatches,
            "failures": r.failures, "restores": r.restores, "peak_bytes": peak,
            "n_params": out["n_params"], "tokens_per_step": tokens,
            "params": out["params"], "opt_state": out["opt_state"]}


def phase_train_time(torch, run: dict, seed: int) -> dict:
    """TRAIN_TIMED_STEPS more steps from the trained state, each timed on
    the host's clock up to a synchronise: ms per step, tokens/s, model
    TFLOP/s; then one profiled step's device idle share."""
    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.runtime.steps import make_train_step

    cfg = resolve(TRAIN_RUN["arch"])
    step = make_train_step(cfg, train_rc(cfg))
    params, opt = run.pop("params"), run.pop("opt_state")
    times = []
    for i in range(TRAIN_TIMED_STEPS):
        batch = make_batch(cfg, TRAIN_RUN["batch"], TRAIN_RUN["seq"], seed=seed,
                           step=100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(metrics["loss"])), "a timed step's loss is not finite")
    batch = make_batch(cfg, TRAIN_RUN["batch"], TRAIN_RUN["seq"], seed=seed, step=200)
    trace = _device_busy(torch, lambda: step(params, opt, batch), watch=("flash_bwd_",))
    ms = statistics.median(times)
    tokens = run["tokens_per_step"]
    flops = train_model_flops(cfg, tokens, TRAIN_RUN["batch"], TRAIN_RUN["seq"])
    idle = trace["device_idle_share"]
    print(f"phase train_time: {', '.join(f'{t:.3f}' for t in times)} ms a step (median "
          f"{ms:.3f}), {tokens / ms * 1e3:.6g} tokens/s, {flops / ms / 1e9:.6g} TFLOP/s "
          f"of model FLOPs ({flops:.6g} a step: 6 N D + attention); a profiled step: wall "
          f"{trace['wall_ms']:.3f} ms, device busy {trace['device_busy_ms']:.3f} ms, idle "
          f"share {'not measured' if idle is None else f'{idle:.3f}'}, "
          f"{trace['kernels_launched']} device operations; largest: "
          + "; ".join(f"{n} {t:.3f} ms" for n, t in trace["top_device_ms"]))
    bwd = trace["watched_device_ms"]
    print(f"phase train_time: the attention backward {sum(bwd.values()):.3f} ms of the "
          f"step's device time ({sum(bwd.values()) / trace['device_busy_ms']:.3f}): "
          + "; ".join(f"{n} {t:.3f} ms" for n, t in sorted(bwd.items())))
    del params, opt
    torch.cuda.empty_cache()
    return {"step_ms": times, "median_step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
            "model_flops": flops, "tflops": flops / ms / 1e9, "trace": trace}


def _loss_and_grads(torch, cfg, rc, params, batch, kernels):
    from torch.utils import _pytree as pytree

    from repro_torch.models import model as M

    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc, batch, kernels=kernels)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float() for g in grads]


def _rel_l2(torch, got: list, want: list) -> list:
    return [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(got, want)]


def phase_train_parity(torch, seed: int) -> dict:
    """One microbatch's loss and gradients through the kernels (K2 and its
    backward, the main path's flash_vjp route) against the plain attention
    (``ref.flash_attention_ref`` under autograd): bfloat16 at full depth,
    also against a kernel-free reordering (:func:`blocked_attention`), and
    float32 at TRAIN_F32_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import batch_to_device

    out = {}
    full = resolve(TRAIN_RUN["arch"])
    B = TRAIN_RUN["batch"] // TRAIN_RUN["microbatches"]
    for dname, cfg in (("bfloat16", full),
                       ("float32", dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS,
                                                       dtype="float32"))):
        rc = train_rc(cfg)
        plain_rc = dataclasses.replace(rc, flash_vjp=False)
        train = ops.train_kernels(rc.mamba_chunk)
        params = M.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(
            seed + 12), device="cuda")
        batch = batch_to_device(make_batch(cfg, B, TRAIN_RUN["seq"], seed=seed, step=300),
                                "cuda")
        lk, gk = _loss_and_grads(torch, cfg, rc, params, batch, train)
        lp, gp = _loss_and_grads(torch, cfg, plain_rc, params, batch,
                                 dataclasses.replace(train, attention=ref.flash_attention_ref))
        rel = _rel_l2(torch, gk, gp)
        del gk
        tol = TRAIN_PARITY_TOL[dname]
        control = None
        allowed = [tol] * len(rel)
        if dname == "bfloat16":
            _, gc = _loss_and_grads(torch, cfg, plain_rc, params, batch,
                                    dataclasses.replace(train, attention=blocked_attention))
            control = _rel_l2(torch, gc, gp)
            del gc
            allowed = [max(tol, CONTROL_FACTOR * c) for c in control]
        del gp, params
        torch.cuda.empty_cache()
        worst = max(range(len(rel)), key=lambda i: rel[i] / allowed[i])
        check(all(r <= a for r, a in zip(rel, allowed)),
              f"train_parity {dname}: gradient leaf {worst} differs from plain by "
              f"relative L2 {rel[worst]:.4g} > {allowed[worst]:.4g}")
        check(abs(lk - lp) <= tol * abs(lp),
              f"train_parity {dname}: loss {lk!r} through the kernels, {lp!r} plain")
        rule = f"{tol}" if control is None else (
            f"{tol} or {CONTROL_FACTOR} x the reordering's; the reordering vs plain: "
            f"median {statistics.median(control):.4g}, max {max(control):.4g}")
        print(f"phase train_parity: {dname} at {depth_of(cfg, full.n_layers)}, one "
              f"microbatch of {B} x {TRAIN_RUN['seq']}: loss {lk!r} through the kernels, "
              f"{lp!r} plain; gradients' relative L2 per leaf over {len(rel)} leaves, "
              f"kernels vs plain: median {statistics.median(rel):.4g}, max {max(rel):.4g} "
              f"(leaf {worst}, allowed {allowed[worst]:.4g}: {rule})")
        out[dname] = {"loss_kernels": lk, "loss_plain": lp, "rel_l2": rel,
                      "control_rel_l2": control, "depth": depth_of(cfg, full.n_layers)}
    return out


# The sharded training path (main path 12): qwen3-0.6b with TRAIN_RUN's batch
# and run config through the sharded step on a (1, 1) ("data", "model") NCCL
# mesh of this process, against as many single-device steps from the same
# state and batches; then the int8-compressed step on a (1, 1, 1) ("pod",
# "data", "model") mesh (one microbatch's rows a step, as the reference's
# compressed step takes no microbatches), elastic resume of phase train's
# checkpoint and the pipeline at one stage.  With one rank every collective
# is an identity, so the sharded step must give the single-device step's
# bits; a parameter or moment that differs is held to
# TRAIN_PARITY_TOL["bfloat16"] (largest relative difference per leaf) with
# the differing leaves printed.
TRAIN_SHARDED = {"steps": 3, "compressed_steps": 8, "compressed_batch": 4,
                 "pp_micro": 6, "pp_rows": 4096}


def _max_rel(torch, got: list, want: list) -> list:
    return [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
            for a, b in zip(got, want)]


def _timed_steps(torch, step, params, opt, batches) -> tuple:
    """Run ``step`` over ``batches`` from (params, opt): the final state,
    the losses, the host ms of each step up to a synchronise, and the peak
    device memory (bytes) and its rise over the memory held at the start."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    return params, opt, losses, times, peak, peak - start


def phase_train_sharded(torch, seed: int, train_ckpt: Path) -> dict:
    """The sharded training path: ``make_train_step(grad_shardings=...)`` on
    a (1, 1) mesh against the single-device step (losses bit-equal, every
    parameter and moment bit-equal or within tolerance, ms / step and peak
    memory of both; the sharded steps' launches counted);
    ``make_compressed_train_step`` on a (1, 1, 1) mesh (losses finite and
    falling, the int8 payload handed to ``all_reduce``; its launches
    counted); ``resume_on_mesh`` of phase train's checkpoint (exact); and
    ``pipeline_apply`` at one stage, bit-equal to the sequential result."""
    import math

    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch import checkpoint as CKPT
    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.runtime.elastic import resume_on_mesh
    from repro_torch.runtime.spmd_train import make_compressed_train_step
    from repro_torch.runtime.steps import make_init, make_train_step

    out = {}
    cfg = resolve(TRAIN_RUN["arch"])
    rc = train_rc(cfg)
    opt_cfg = AdamWConfig(state_dtype=rc.opt_state_dtype, weight_decay=rc.weight_decay,
                          grad_clip=rc.grad_clip)
    t_phase = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"))
    world = dist.get_world_size()
    check(world == 1 and dist.get_backend() == "nccl",
          f"the phase's mesh has {world} ranks over {dist.get_backend()}, not 1 over nccl")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params0, opt0 = make_init(cfg, rc, opt_cfg, device="cuda")(gen)
    batches = [make_batch(cfg, TRAIN_RUN["batch"], TRAIN_RUN["seq"], seed=seed, step=300 + i)
               for i in range(TRAIN_SHARDED["steps"])]

    single = make_train_step(cfg, rc, opt_cfg)
    p1, o1, loss1, ms1, peak1, rise1 = _timed_steps(torch, single, params0, opt0, batches)

    pshard = SH.param_shardings(mesh, M.abstract_params(cfg))
    oshard = SH.opt_state_shardings(mesh, opt0, pshard)
    ps, os_ = SH.place(params0, pshard), SH.place(opt0, oshard)
    del params0, opt0
    sharded = make_train_step(cfg, rc, opt_cfg, grad_shardings=pshard)
    zero_counts()
    p2, o2, loss2, ms2, peak2, rise2 = _timed_steps(torch, sharded, ps, os_, batches)
    counts = read_counts()
    del ps, os_
    per_step = cfg.n_layers * TRAIN_RUN["microbatches"]
    n = TRAIN_SHARDED["steps"]
    check(counts == {"fused_conv3x3": 0, "flash_attention": 2 * per_step * n,
                     "fused_mlp": 0, "selective_scan": 0,
                     "flash_attention_bwd": per_step * n},
          f"the sharded steps launched {counts}, not flash_attention twice and "
          f"flash_attention_bwd once per layer per microbatch: {n} steps x "
          f"{cfg.n_layers} layers x {TRAIN_RUN['microbatches']}")
    print(f"phase main_path train_sharded: launches {counts} ({n} sharded steps x "
          f"{cfg.n_layers} layers x {TRAIN_RUN['microbatches']} microbatches)")
    check(all(math.isfinite(x) for x in loss2), f"non-finite sharded losses {loss2}")
    check(loss1 == loss2, f"sharded losses {loss2} differ from the single-device "
          f"step's {loss1}")
    names = ["/".join(map(str, k)) for k, _ in pytree.tree_flatten_with_path(p1)[0]]
    leaves = {"params": (pytree.tree_leaves(p2), pytree.tree_leaves(p1)),
              "m": (pytree.tree_leaves(o2["m"]), pytree.tree_leaves(o1["m"])),
              "v": (pytree.tree_leaves(o2["v"]), pytree.tree_leaves(o1["v"]))}
    parity = {}
    for what, (got, want) in leaves.items():
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        rel = _max_rel(torch, got, want)
        differ = [f"{names[i]} {rel[i]:.3g}" for i, e in enumerate(equal) if not e]
        parity[what] = {"bit_equal": sum(equal), "leaves": len(equal),
                        "max_rel": max(rel), "differ": differ[:20]}
        if differ:
            tol = TRAIN_PARITY_TOL["bfloat16"]
            check(max(rel) <= tol, f"sharded {what}: largest relative difference "
                  f"{max(rel):.3g} > {tol} ({differ[:5]})")
            print(f"phase train_sharded: {what}: {len(differ)} of {len(equal)} leaves "
                  f"not bit-equal, largest relative difference {max(rel):.3g} (<= "
                  f"{TRAIN_PARITY_TOL['bfloat16']}); differing leaves: {differ[:8]}")
    del p1, o1, p2, o2, leaves
    torch.cuda.empty_cache()
    ms_1, ms_2 = statistics.median(ms1), statistics.median(ms2)
    print(f"phase train_sharded: {cfg.name} bfloat16, {n} steps of {TRAIN_RUN['batch']} x "
          f"{TRAIN_RUN['seq']} tokens on a {tuple(mesh.shape)} {mesh.mesh_dim_names} "
          f"nccl mesh of {world} rank against as many single-device steps from the same "
          f"state and batches: losses {loss2} "
          + ("bit-equal" if loss1 == loss2 else f"against {loss1}")
          + "; parameters / m / v bit-equal in "
          + ", ".join(f"{parity[w]['bit_equal']} / {parity[w]['leaves']}" for w in parity)
          + f" leaves; ms a step {', '.join(f'{t:.3f}' for t in ms2)} (median {ms_2:.3f}) "
          f"sharded, {', '.join(f'{t:.3f}' for t in ms1)} (median {ms_1:.3f}) single; peak "
          f"device memory {peak2 / 2**30:.3f} GiB sharded ({rise2 / 2**30:.3f} above its "
          f"start), {peak1 / 2**30:.3f} GiB single ({rise1 / 2**30:.3f} above its start)")
    out.update({"losses_sharded": loss2, "losses_single": loss1, "ms_sharded": ms2,
                "ms_single": ms1, "peak_sharded": peak2, "peak_single": peak1,
                "rise_sharded": rise2, "rise_single": rise1, "parity": parity,
                "counts": counts})

    # The int8-compressed step over the pod axis.
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params, opt = make_init(cfg, rc, opt_cfg, device="cuda")(gen)
    cstep, init_ef = make_compressed_train_step(cfg, rc, mesh3, opt_cfg)
    ef = init_ef(params)
    wire = []
    plain = dist.all_reduce

    def recording_all_reduce(tensor, *args, **kwargs):
        wire.append(tensor.dtype)
        return plain(tensor, *args, **kwargs)

    closs, cms = [], []
    zero_counts()
    dist.all_reduce = recording_all_reduce
    try:
        for i in range(TRAIN_SHARDED["compressed_steps"]):
            batch = make_batch(cfg, TRAIN_SHARDED["compressed_batch"], TRAIN_RUN["seq"],
                               seed=seed, step=400 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, ef, metrics = cstep(params, opt, ef, batch)
            torch.cuda.synchronize()
            cms.append((time.perf_counter() - t0) * 1e3)
            closs.append(float(metrics["loss"]))
    finally:
        dist.all_reduce = plain
    ccounts = read_counts()
    n_leaves = len(pytree.tree_leaves(params))
    nc = TRAIN_SHARDED["compressed_steps"]
    del params, opt, ef
    torch.cuda.empty_cache()
    check(ccounts == {"fused_conv3x3": 0, "flash_attention": 2 * cfg.n_layers * nc,
                      "fused_mlp": 0, "selective_scan": 0,
                      "flash_attention_bwd": cfg.n_layers * nc},
          f"the compressed steps launched {ccounts}, not flash_attention twice and "
          f"flash_attention_bwd once per layer per step ({nc} x {cfg.n_layers})")
    n_int8 = sum(d == torch.int8 for d in wire)
    check(n_int8 == nc * n_leaves, f"{n_int8} int8 all-reduces, not one per gradient "
          f"leaf per step ({nc} x {n_leaves})")
    check(all(math.isfinite(x) for x in closs) and closs[-1] < closs[0],
          f"the compressed steps' losses {closs} are not finite and falling")
    print(f"phase main_path train_sharded compressed: launches {ccounts} ({nc} steps x "
          f"{cfg.n_layers} layers, one microbatch of {TRAIN_SHARDED['compressed_batch']} x "
          f"{TRAIN_RUN['seq']} a step)")
    print(f"phase train_sharded compressed: {nc} steps on a {tuple(mesh3.shape)} "
          f"{mesh3.mesh_dim_names} mesh; losses " + ", ".join(f"{x:.4f}" for x in closs)
          + f"; all_reduce payloads: {n_int8} int8 ({n_leaves} gradient leaves a step), "
          + ", ".join(f"{sum(d == t for d in wire)} {str(t).removeprefix('torch.')}"
                      for t in sorted(set(wire) - {torch.int8}, key=str))
          + f"; ms a step {', '.join(f'{t:.3f}' for t in cms)} (median "
          f"{statistics.median(cms):.3f})")
    out.update({"compressed_losses": closs, "compressed_ms": cms,
                "compressed_counts": ccounts, "int8_payloads": n_int8})

    # Elastic resume of phase train's checkpoint onto the (1, 1) mesh.
    step = CKPT.latest_step(train_ckpt)
    check(step is not None, f"phase train left no checkpoint in {train_ckpt}")
    t0 = time.perf_counter()
    rp, ro = resume_on_mesh(train_ckpt, step, cfg, mesh, opt_cfg=opt_cfg)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    saved, _ = CKPT.restore(train_ckpt, step)
    diff = 0.0
    for prefix, tree in (("params", rp), ("opt", ro)):
        for path, t in pytree.tree_flatten_with_path(tree)[0]:
            key = "/".join([prefix] + [str(getattr(k, "key", getattr(k, "idx", k)))
                                       for k in path])
            want = CKPT.device_put_like(saved[key], t.device)
            diff = max(diff, float((t.float() - want.float()).abs().max()))
    del rp, ro, saved
    torch.cuda.empty_cache()
    check(diff == 0.0, f"resume_on_mesh differs from the saved step by {diff}")
    print(f"phase train_sharded elastic: phase train's step-{step} checkpoint resumed onto "
          f"the {tuple(mesh.shape)} mesh in {resume_s:.3f} s (read, verified and placed); "
          f"largest difference from the saved parameters and moments {diff}")
    out.update({"resume_step": step, "resume_s": resume_s, "resume_diff": diff})

    # The pipeline at the one stage this world allows.
    stage_mesh = make_mesh((1,), ("stage",))
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = cfg.d_model
    ws = (torch.randn((1, d, d), generator=g, device="cuda") / math.sqrt(d)).to(torch.bfloat16)
    x = torch.randn((TRAIN_SHARDED["pp_micro"], TRAIN_SHARDED["pp_rows"], d), generator=g,
                    device="cuda").to(torch.bfloat16)

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    y = pipeline_apply(stage_fn, ws, x, mesh=stage_mesh)
    seq = torch.stack([stage_fn(ws[0], x[t]) for t in range(x.shape[0])])
    check(torch.equal(y, seq), "pipeline_apply differs from the sequential result: "
          f"max |diff| {float((y.float() - seq.float()).abs().max())}")
    print(f"phase train_sharded pipeline: 1 stage x {x.shape[0]} microbatches of "
          f"({TRAIN_SHARDED['pp_rows']}, {d}) bfloat16, tanh(x @ w): bit-equal to the "
          "sequential result")
    dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase train_sharded: {out['seconds']:.1f} s")
    return out


def _sdpa_backward(torch, q, k, v, dout, causal: bool, window: int, chunk: int):
    """PyTorch's scaled_dot_product_attention's backward on the same
    inputs (GQA; a window or chunk mask as a boolean ``attn_mask``), as a
    zero-argument callable: the forward once, then each call one
    ``autograd.grad`` (the yardstick, not the port's)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    if window or chunk:
        kw = dict(attn_mask=ref._visible(q.shape[1], k.shape[1], causal, window, chunk,
                                         q.device))
    else:
        kw = dict(is_causal=causal)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    dot = dout.transpose(1, 2)

    def library():
        return torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    return library


def phase_train_kernel(torch, spec, seed: int) -> list:
    """flash_attention_bwd vs its plain version at TRAIN_KERNEL_CASES, both
    given K2's own output and logsumexp; at qwen3's training shape also two
    runs bit for bit, the time of PyTorch's SDPA backward and a row for
    K2's forward with its logsumexp."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd, fused_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    rows = []
    for label, shape, dname, causal, window, chunk in TRAIN_KERNEL_CASES:
        B, Sq, Skv, H, KV, hd = shape
        dtype = getattr(torch, dname)
        mask = dict(causal=causal, window=window, chunk=chunk)
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KV, hd), generator=gen, device="cuda").to(dtype)
        dout = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
        out, lse = fused_attention.flash_attention_lse(q, k, v, **mask)

        def kernel():
            return flash_attention_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **mask)

        def plain():
            return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **mask)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        tol = BWD_TOL[dname]
        errs, rels = [], []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()), f"flash_attention_bwd {label}: non-finite {name}")
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            ok = (bool(((g - w).abs() <= tol + tol * w.abs()).all()) if dname == "float32"
                  else err <= tol * scale)
            check(ok, f"flash_attention_bwd {label} {shape} {dname} {mask}: {name} differs "
                  f"from plain by up to {err} (largest {scale}, tolerance {tol})")
            errs.append(err)
            rels.append(err / scale)
        del want
        deterministic = None
        if label == "train":
            again = kernel()
            deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
            check(deterministic, "flash_attention_bwd: two runs on the same inputs differ")
            del again
        del got
        library = _sdpa_backward(torch, q, k, v, dout, causal, window, chunk)
        ms, one = time_kernel(torch, {"kernel": kernel, "library": library})
        plain_ms = time_ms(torch, {"plain": plain}, 3 if label == "train" else REPS)["plain"]
        es = q.element_size()
        pairs = _visible_pairs(Sq, Skv, causal, window, chunk)
        flops = 10 * B * H * hd * pairs  # five products of 2 hd flops a pair and head
        n_bytes = es * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * lse.numel()
        t_b = spec.memory_seconds(n_bytes) * 1e3
        t_o = spec.compute_seconds(flops, es) * 1e3
        backend = sdpa_kernel_names(torch, library,
                                    ("bwd", dname, causal, bool(window or chunk)))
        row = {"case": label, "shape": list(shape), "dtype": dname, **mask,
               "max_abs_err": max(errs), "max_rel_err": max(rels), "ms": ms["kernel"],
               "call_ms": one["kernel"], "plain_ms": plain_ms,
               "library_ms": ms["library"], "library_backend": backend,
               "bytes": n_bytes, "flops": flops, "bound_ms": max(t_b, t_o),
               "bound_by": "operations" if t_o >= t_b else "bytes",
               "deterministic": deterministic}
        rows.append(row)
        lib = f"{row['library_ms']:.4f} ms [{backend}]"
        print(f"train_kernel flash_attention_bwd {label} {shape} {dname} causal="
              f"{int(causal)} w={window} c={chunk}: kernel {row['ms']:.4f} ms (one call "
              f"{row['call_ms']:.4f}), plain {plain_ms:.4f} ms, SDPA backward {lib}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {flops / row['ms'] / 1e9:.4g} "
              f"TFLOP/s), max_abs_err {max(errs):.3g} (of the largest: {max(rels):.3g})"
              + ("" if deterministic is None else ", two runs bit-equal"))
        if label == "train":  # K2's forward with its logsumexp at the training shape
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def fwd_kernel():
                return fused_attention.flash_attention_lse(q, k, v, **mask)

            def fwd_plain():
                return ref.flash_attention_ref(q, k, v, **mask), ref.attention_lse_ref(q, k, **mask)

            def fwd_library():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)

            want_o, want_lse = fwd_plain()
            got_o, got_lse = fwd_kernel()
            err = float((got_o.float() - want_o.float()).abs().max())
            lse_err = float((got_lse - want_lse).abs().max())
            check(err <= ATT_TOL[dname] * (1 + float(want_o.float().abs().max()))
                  and lse_err <= 1e-4 * (1 + float(want_lse.abs().max())),
                  f"flash_attention with lse at the training shape: out {err}, lse {lse_err}")
            del want_o, want_lse, got_o, got_lse
            fms, fone = time_kernel(torch, {"kernel": fwd_kernel, "library": fwd_library})
            fplain = time_ms(torch, {"plain": fwd_plain}, 3)["plain"]
            fflops = 4 * B * H * hd * pairs
            fbytes = es * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
            ft_b = spec.memory_seconds(fbytes) * 1e3
            ft_o = spec.compute_seconds(fflops, es) * 1e3
            frow = {"case": "train_forward_lse", "shape": list(shape), "dtype": dname,
                    **mask, "max_abs_err": err, "lse_max_abs_err": lse_err,
                    "ms": fms["kernel"], "call_ms": fone["kernel"], "plain_ms": fplain,
                    "library_ms": fms["library"], "bytes": fbytes, "flops": fflops,
                    "bound_ms": max(ft_b, ft_o),
                    "bound_by": "operations" if ft_o >= ft_b else "bytes"}
            rows.append(frow)
            print(f"train_kernel flash_attention with lse {shape} {dname} causal: kernel "
                  f"{frow['ms']:.4f} ms (one call {frow['call_ms']:.4f}), plain "
                  f"{fplain:.4f} ms, SDPA {frow['library_ms']:.4f} ms, bound "
                  f"{frow['bound_ms']:.4f} ms ({frow['bound_by']}, "
                  f"{fflops / frow['ms'] / 1e9:.4g} TFLOP/s), max_abs_err {err:.3g}, lse "
                  f"{lse_err:.3g}")
        del q, k, v, dout, out, lse, library
        torch.cuda.empty_cache()
    return rows


def serve_entry(name: str, source: str, parts: list, launches: int) -> dict:
    """A kernels-line entry summed over the serving run's launches:
    ``parts`` is [(row, launches at that row's shape), ...]; no library time
    when a row has none."""
    t_b = sum(r["bound_ms"] * n for r, n in parts if r["bound_by"] == "bytes")
    t_o = sum(r["bound_ms"] * n for r, n in parts if r["bound_by"] == "operations")
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r, _ in parts),
        "ms": sum(r["ms"] * n for r, n in parts),
        "plain_ms": sum(r["plain_ms"] * n for r, n in parts),
        "bound_ms": t_b + t_o,
        "bound_by": "operations" if t_o >= t_b else "bytes",
        "library_ms": (None if any(r["library_ms"] is None for r, _ in parts)
                       else sum(r["library_ms"] * n for r, n in parts)),
    }


def kernels_entry(rows: list, launches: int, spec) -> dict:
    """The fused_conv3x3 entry of the kernels line: times summed over the
    13 layers at the main path's shapes (batch 8, float32)."""
    main = [r for r in rows if r["batch"] == BATCH and r["dtype"] == "float32"]
    t_bytes = spec.memory_seconds(sum(r["bytes"] for r in main)) * 1e3
    flops = sum(r["flops"] for r in main)
    t_cores, t_3x = conv_op_bounds(spec, flops, 4)
    t_ops = min(t_cores, t_3x)
    print(f"fused_conv3x3 over the forward (batch {BATCH}, float32, {flops / 1e9:.6g} "
          f"GFLOP): kernel {sum(r['ms'] for r in main):.4f} ms, cuDNN "
          f"{sum(r['library_ms'] for r in main):.4f} ms, plain "
          f"{sum(r['plain_ms'] for r in main):.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
          f"(CUDA cores {t_cores:.4f}, 3xTF32 {t_3x:.4f}, bytes {t_bytes:.4f})")
    return {
        "name": "fused_conv3x3",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_conv3x3.cu",
        "replaces": REPLACES["fused_conv3x3"],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in main),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every generator (default 0)")
    args = parser.parse_args(argv)

    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"{e}: the port needs PyTorch and numpy")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the "
             "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import resolve
    from repro_torch.core.arch import gpu_spec
    from repro_torch.core.ir import vgg16_ir
    from repro_torch.core.planner import plan_model

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32 (TF32 is on)")

    t_start = time.perf_counter()
    card = phase_device(torch)
    build = phase_build()
    spec = gpu_spec()
    vgg = vgg16_ir(pool_mode="separate")

    # ---- main path 1, the paper's VGG-16 flow: counts zeroed just before,
    # read just after ----
    zero_counts()
    paper = phase_paper_flow(vgg)
    exhaustive, vgg_flow = phase_exhaustive(torch, np, vgg, args.seed)
    model, x, forward = phase_forward(torch, args.seed)
    vgg_counts = read_counts()
    check(vgg_counts["fused_conv3x3"] > 0, "the VGG-16 path never launched fused_conv3x3")
    print(f"phase main_path vgg16: launches {vgg_counts}")
    forward["ms"] = time_forward(torch, model, x)
    del model, x
    torch.cuda.empty_cache()

    # ---- main path 4, the grouping search on DAGs: counts zeroed just
    # before, read just after (it runs no kernel of K1-K4) ----
    zero_counts()
    dag, ed_flow = phase_dag_search(torch, np, args.seed)
    dag_counts = read_counts()
    check(not any(dag_counts.values()),
          f"the DAG search path launched kernels: {dag_counts}")
    print(f"phase main_path dag_search: launches {dag_counts}")

    # ---- main path 5, the tracing frontend: counts zeroed just before, read
    # just after (its traces, sweeps and forwards run no kernel of K1-K4) ----
    zero_counts()
    traces = phase_frontend_traces()
    frontend = {"traces": traces["rows"],
                "sweeps": phase_frontend_sweeps(np, traces["graphs"]),
                "forwards": phase_frontend_forwards(torch, args.seed)}
    del traces
    frontend_counts = read_counts()
    check(not any(frontend_counts.values()),
          f"the frontend path launched kernels: {frontend_counts}")
    print(f"phase main_path frontend: launches {frontend_counts}")

    # ---- main path 6, the fleet sweep: counts zeroed just before, read just
    # after (float64 torch code and host numpy; no kernel of K1-K4) ----
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        fleet = {"exhaustive": phase_fleet_exhaustive(
                     torch, np, {"vgg16_ir": vgg_flow, "encoder_decoder_ir": ed_flow},
                     args.seed),
                 "cosearch": phase_fleet_cosearch(torch, np, Path(tmp))}
    del vgg_flow, ed_flow
    fleet_counts = read_counts()
    check(not any(fleet_counts.values()),
          f"the fleet path launched kernels: {fleet_counts}")
    print(f"phase main_path fleet: launches {fleet_counts}")

    # ---- main path 7, the planning service: counts zeroed just before, read
    # just after (it sweeps through run_fleet; no kernel of K1-K4) ----
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as tmp:
        service = phase_service(torch, np, Path(tmp), args.seed)
    service_counts = read_counts()
    check(not any(service_counts.values()),
          f"the service path launched kernels: {service_counts}")
    print(f"phase main_path service: launches {service_counts}")

    # ---- main path 2, serving qwen3-0.6b: counts zeroed just before, read
    # just after ----
    plans = phase_plan(spec)
    qwen = resolve(SERVE["arch"])
    zero_counts()
    serve_run = phase_serve(np, SERVE, args.seed)
    serve_counts = read_counts()
    n_layers, n_gen = qwen.n_layers, SERVE["gen"]
    check(serve_counts["flash_attention"] == n_layers,
          f"serving launched flash_attention {serve_counts['flash_attention']} "
          f"times, not once per layer of the prefill ({n_layers})")
    check(serve_counts["fused_mlp"] == n_layers * n_gen,
          f"serving launched fused_mlp {serve_counts['fused_mlp']} times, not "
          f"{n_layers} layers x {n_gen} forwards = {n_layers * n_gen}")
    check(serve_counts["flash_attention_bwd"] == 0,
          f"serving launched the attention backward: {serve_counts}")
    print(f"phase main_path serve: launches {serve_counts}")
    torch.cuda.empty_cache()

    serve_time = phase_serve_time(torch, SERVE, args.seed, PREFILL_TOL)
    torch.cuda.empty_cache()

    # ---- main path 3, serving falcon-mamba-7b: counts zeroed just before,
    # read just after ----
    mamba = resolve(SERVE_SSM["arch"])
    zero_counts()
    ssm_run = phase_serve(np, SERVE_SSM, args.seed, "serve_ssm")
    ssm_counts = read_counts()
    n_ssm = mamba.n_layers * SERVE_SSM["gen"]
    check(ssm_counts["selective_scan"] == n_ssm,
          f"serving {mamba.name} launched selective_scan "
          f"{ssm_counts['selective_scan']} times, not {mamba.n_layers} layers x "
          f"(1 prefill + {SERVE_SSM['gen'] - 1} decode steps) = {n_ssm}")
    check(ssm_counts["flash_attention"] == 0 and ssm_counts["fused_mlp"] == 0
          and ssm_counts["flash_attention_bwd"] == 0,
          f"serving {mamba.name} (no attention, no MLP) launched {ssm_counts}")
    print(f"phase main_path serve_ssm: launches {ssm_counts}")
    torch.cuda.empty_cache()
    ssm_time = phase_serve_time(torch, SERVE_SSM, args.seed, SSM_PREFILL_TOL,
                                SSM_F32_LAYERS, "serve_ssm_time", control=scan_control)
    torch.cuda.empty_cache()

    # ---- main path 8, serving mixtral-8x7b (16 of 32 layers): counts
    # zeroed just before, read just after ----
    moe_cfg = serve_config(SERVE_MOE)
    zero_counts()
    moe_run = phase_serve(np, SERVE_MOE, args.seed, "serve_moe")
    moe_counts = read_counts()
    check(moe_counts == {"fused_conv3x3": 0, "flash_attention": moe_cfg.n_layers,
                         "fused_mlp": 0, "selective_scan": 0, "flash_attention_bwd": 0},
          f"serving {moe_cfg.name} launched {moe_counts}, not flash_attention "
          f"once per layer of the prefill ({moe_cfg.n_layers}) and nothing else")
    print(f"phase main_path serve_moe: launches {moe_counts}")
    torch.cuda.empty_cache()
    moe_time = phase_serve_time(torch, SERVE_MOE, args.seed, PREFILL_TOL,
                                MOE_F32_LAYERS, "serve_moe_time",
                                control=attention_control)
    torch.cuda.empty_cache()

    # ---- main path 9, serving seamless-m4t-large-v2: counts zeroed just
    # before, read just after ----
    ed_cfg = resolve(SERVE_ENCDEC["arch"])
    zero_counts()
    encdec_run = phase_serve(np, SERVE_ENCDEC, args.seed, "serve_encdec")
    encdec_counts = read_counts()
    n_att = ed_cfg.n_enc_layers + 2 * ed_cfg.n_layers
    n_mlp = ed_cfg.n_enc_layers + ed_cfg.n_layers * SERVE_ENCDEC["gen"]
    check(encdec_counts == {"fused_conv3x3": 0, "flash_attention": n_att,
                            "fused_mlp": n_mlp, "selective_scan": 0,
                            "flash_attention_bwd": 0},
          f"serving {ed_cfg.name} launched {encdec_counts}, not flash_attention "
          f"{n_att} times in the prefill ({ed_cfg.n_enc_layers} encoder, "
          f"{ed_cfg.n_layers} self and {ed_cfg.n_layers} cross) and fused_mlp "
          f"{n_mlp} ({ed_cfg.n_enc_layers} encoder + {ed_cfg.n_layers} decoder "
          f"layers x {SERVE_ENCDEC['gen']} forwards)")
    print(f"phase main_path serve_encdec: launches {encdec_counts}")
    torch.cuda.empty_cache()
    encdec_time = phase_serve_time(torch, SERVE_ENCDEC, args.seed, PREFILL_TOL,
                                   phase="serve_encdec_time", control=attention_control)
    torch.cuda.empty_cache()

    # ---- main path 10, serving gemma3-27b's superblock through the ring
    # cache: counts zeroed just before, read just after its run ----
    ring_cfg = serve_config(SERVE_RING)
    zero_counts()
    ring = phase_serve_ring(torch, SERVE_RING, args.seed)
    ring_counts = ring["ring_counts"]
    n_ring = ring_cfg.n_layers
    check(ring_counts == {"fused_conv3x3": 0, "flash_attention": n_ring,
                          "fused_mlp": n_ring * SERVE_RING["gen"], "selective_scan": 0,
                          "flash_attention_bwd": 0},
          f"serving {ring_cfg.name} through the ring launched {ring_counts}, not "
          f"flash_attention once per layer of the prefill ({n_ring}) and fused_mlp "
          f"{n_ring} layers x {SERVE_RING['gen']} forwards")
    print(f"phase main_path serve_ring: launches {ring_counts}")
    torch.cuda.empty_cache()

    # ---- main path 11, training qwen3-0.6b through launch.train: counts
    # zeroed just before, read just after ----
    train_cfg = resolve(TRAIN_RUN["arch"])
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_run = phase_train(torch, args.seed, Path(tmp))
        train_counts = read_counts()
        n_steps = train_run["steps_run"] + train_run["redispatches"]
        per_step = train_cfg.n_layers * TRAIN_RUN["microbatches"]
        check(train_counts == {"fused_conv3x3": 0,
                               "flash_attention": 2 * per_step * n_steps,
                               "fused_mlp": 0, "selective_scan": 0,
                               "flash_attention_bwd": per_step * n_steps},
              f"training launched {train_counts}, not flash_attention twice (the forward "
              f"and its recompute) and flash_attention_bwd once per layer per microbatch: "
              f"{n_steps} steps x {train_cfg.n_layers} layers x {TRAIN_RUN['microbatches']}")
        print(f"phase main_path train: launches {train_counts} ({n_steps} train steps x "
              f"{train_cfg.n_layers} layers x {TRAIN_RUN['microbatches']} microbatches: "
              "flash_attention twice each, the forward and its recompute under full "
              "remat, flash_attention_bwd once)")
        train_time = phase_train_time(torch, train_run, args.seed)
        train_parity = phase_train_parity(torch, args.seed)
        torch.cuda.empty_cache()

        # ---- main path 12, the sharded training path: the counts of its
        # sharded and its compressed steps, each zeroed just before and read
        # just after (checked in the phase); it resumes phase train's
        # checkpoint ----
        train_sharded = phase_train_sharded(torch, args.seed, Path(tmp))
        torch.cuda.empty_cache()

    layer_rows = phase_layers(torch, spec, args.seed)
    plan = plan_model(qwen, 4096, spec)
    att_rows = phase_attention(torch, spec, args.seed,
                               (plan.attn_block_q, plan.attn_block_k))
    mlp_rows = phase_mlp(torch, spec, args.seed, (plan.mlp_block_m, plan.mlp_block_f))
    scan_rows = phase_scan(torch, spec, args.seed)
    bwd_rows = phase_train_kernel(torch, spec, args.seed)

    def row(rows, case, dtype):
        return next(r for r in rows if r["case"] == case and r.get("dtype") == dtype)

    entries = [
        kernels_entry(layer_rows, vgg_counts["fused_conv3x3"], spec),
        serve_entry("flash_attention",
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                    [(row(att_rows, "serve", "bfloat16"), n_layers)],
                    serve_counts["flash_attention"]),
        serve_entry("fused_mlp", "src/repro_torch/kernels/csrc/fused_mlp.cu",
                    [(row(mlp_rows, "serve_prefill", "bfloat16"), n_layers),
                     (row(mlp_rows, "serve_decode", "bfloat16"),
                      n_layers * (n_gen - 1))],
                    serve_counts["fused_mlp"]),
        serve_entry("selective_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
                    [(row(scan_rows, "serve_prefill", "float32"), mamba.n_layers),
                     (row(scan_rows, "serve_decode", "float32"),
                      mamba.n_layers * (SERVE_SSM["gen"] - 1))],
                    ssm_counts["selective_scan"]),
        serve_entry("flash_attention_bwd",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    [(row(bwd_rows, "train", "bfloat16"), train_counts["flash_attention_bwd"])],
                    train_counts["flash_attention_bwd"]),
    ]

    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "build": build, "paper_flow": paper,
        "exhaustive": exhaustive, "forward": forward, "dag_search": dag,
        "dag_search_counts": dag_counts, "frontend": frontend,
        "frontend_counts": frontend_counts, "fleet": fleet,
        "fleet_counts": fleet_counts, "service": service,
        "service_counts": service_counts, "layers": layer_rows,
        "plans": plans, "serve": serve_run, "serve_counts": serve_counts,
        "serve_time": serve_time, "serve_ssm": ssm_run, "serve_ssm_counts": ssm_counts,
        "serve_ssm_time": ssm_time, "serve_moe": moe_run, "serve_moe_counts": moe_counts,
        "serve_moe_time": moe_time, "serve_encdec": encdec_run,
        "serve_encdec_counts": encdec_counts, "serve_encdec_time": encdec_time,
        "serve_ring": ring, "train": train_run, "train_counts": train_counts,
        "train_time": train_time, "train_parity": train_parity,
        "train_sharded": train_sharded,
        "attention": att_rows, "mlp": mlp_rows, "scan": scan_rows,
        "train_kernel": bwd_rows, "kernels": entries,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    print(f"phase done: {time.perf_counter() - t_start:.1f} s, "
          f"report {REPORT}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
