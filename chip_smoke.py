#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's sixteen main paths through the entry points a user calls,
at full width, and holds every kernel of those paths against its plain
PyTorch version.  Phases, one line each:

1. device      the card's name and power limit, as nvidia-smi gives them;
2. build       the fused_conv3x3, flash_attention, fused_mlp,
               selective_scan and flash_attention_bwd kernels, built with
               nvcc from the checkout, one nvcc each, together; for
               flash_attention_bwd the registers, spills and HMMA
               instructions of each instantiation, failing if one that
               training launches has no HGMMA or spills; for
               flash_attention and fused_mlp the registers, spills and
               tensor-core (HMMA / HGMMA) instructions of each bfloat16
               instantiation, failing if one that serving launches has
               none, and if flash_attention's wgmma instantiations that
               serving and training launch have no HGMMA, spill or are
               serialized by ptxas; for fused_conv3x3 those of its float32
               instantiations (3xTF32 on wgmma), failing if one that the
               VGG path launches has no HGMMA, spills or has its wgmma
               serialized by ptxas, of its bfloat16 ones (mma.sync), failing
               if one has no HMMA or spills, and of its weight-prep and
               input-staging kernels;
3. paper flow  run_flow on the paper's configuration set and compare_fusion,
               held to the reference suite's locks (tests/test_flow.py);
4. exhaustive  run_flow over the 320-point default space x all 2^17 VGG-16
               groupings (41,943,040 candidates), held bit for bit to the
               scalar oracles (the best point and a seeded 4,096-cell sample);
5. forward     the 224x224 VGG-16 forward, batch 8, float32, through the
               kernel, against the plain forward;
   phases 3-5 are the first main path: the launch counts are zeroed just
   before and read just after it;
6. vgg_train   training VGG-16 through ``models.vgg`` -- the fourteenth
               main path, counts zeroed just before and read just after:
               224x224 x 3, 1,000 classes, float32, batch 8, weights from
               ``init_params`` seeded by ``--seed``, 10 SGD+momentum steps
               through ``loss_fn`` and autograd with cuDNN's TF32 off in
               forward and backward; ms a step (median of the warm steps by
               CUDA events), images/s, model TFLOP/s (3 x 30.94 GFLOP an
               image) against the CUDA-core bound, peak memory, the losses;
               the first step's gradients against float64 replaying the
               float32 forward's ReLU and pool gates (relative L2 per leaf
               within VGG_GRAD_TOL, and a step with TF32 on in the backward
               shown to exceed it); the trained parameters' forward through
               fused_conv3x3 (13 launches) against the plain forward within
               LOGIT_TOL;
7. dag_search  the grouping search on DAGs -- the fourth main path, counts
               zeroed just before and read just after (it launches none of
               the four kernels): resnet18_ir (224x224), residual_block_ir
               and encoder_decoder_ir, the frontier DP's locked optima with
               their host ms, run_flow(groupings="search") on ResNet-18 over
               the default space and compare_fusion at the DP's cuts, and
               the exhaustive sweep of the encoder-decoder graph (320 x
               262,144 = 83,886,080 candidates), re-timed with CUDA events,
               a seeded 4,096-cell sample held bit for bit to the scalar
               oracles and its least bandwidth to the DP optimum's;
8. frontend    the tracing frontend -- the fifth main path, counts zeroed
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
9. fleet       the fleet sweep -- the sixth main path, counts zeroed just
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
10. service     the planning service -- the seventh main path, counts zeroed
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
11. plan       plan_model for all 11 registry configs at 4096 tokens; every
               chosen tile (the selective scan's too, for the configs with
               Mamba layers) fits the card's opt-in shared memory;
12. serve      ``repro_torch.launch.serve.main`` on qwen3-0.6b at full width
               and depth (28 layers, bfloat16): 8 requests, prompt 512, 32
               generated tokens -- the second main path, counts zeroed just
               before and read just after: flash_attention once per layer
               in the prefill, fused_mlp once per layer per forward;
13. serve_time prefill ms, decode ms per token and tokens/s through the
               kernels and, for comparison, through their plain versions;
               prefill logits through the kernels against the plain path in
               bfloat16 and in float32; a profiled prefill and four decode
               steps;
14. serve_ssm  ``serve.main`` on falcon-mamba-7b at full width and depth (64
               layers, bfloat16), 8 requests, prompt 512, 32 generated
               tokens -- the third main path, counts zeroed just before and
               read just after: selective_scan once per layer in the prefill
               and once per layer per decode step, no flash_attention or
               fused_mlp;
15. serve_ssm_time   as serve_time, for falcon-mamba (the float32 logits at a
               cut depth, printed);
16. serve_moe  mixtral-8x7b at full width, 16 of its 32 layers (the 32-layer
               model's 93.1 GB of bfloat16 weights do not fit the card),
               through ``serve.main --layers 16``, 8 requests, prompt 512,
               32 generated tokens -- the eighth main path, counts zeroed
               just before and read just after: flash_attention once per
               layer in the prefill (the sliding window of 4096), no
               fused_mlp (the experts are plain products: on each expert's
               sorted rows, models/moe.py);
17. serve_moe_time   as serve_time, for mixtral (the float32 logits at 2
               layers); the bfloat16 logits also against a kernel-free
               reordering of the attention (the router's top-2 may flip);
18. serve_encdec     ``serve.main`` on seamless-m4t-large-v2 at full width
               and depth (24 encoder + 24 decoder layers, bfloat16), 8
               requests of 1024 frames and a 512-token prompt, 32 generated
               tokens -- the ninth main path, counts zeroed just before and
               read just after: flash_attention 72 times in the prefill
               (the encoder's non-causal self-attention, the decoder's
               causal one, cross-attention over the frames), fused_mlp once
               per layer per forward (48 in the prefill, 24 a decode step);
19. serve_encdec_time   as serve_time, for seamless, both logits at full
               depth, the bfloat16 ones also against the reordering;
20. serve_ring gemma3-27b at full width, one superblock (5 sliding-window
               layers of 1024 + 1 global), 8 requests, prompt 1280, 32
               generated tokens, through runtime.steps with
               ``local_ring_cache`` and a ring cache -- the tenth main path,
               counts zeroed just before and read just after:
               flash_attention once per layer in the prefill, fused_mlp
               once per layer per forward; then the same tokens through the
               full cache: the logits within the bfloat16 tolerance,
               each cache's bytes;
21. serve_zoo  the registry's six other families at full width (SERVE_ZOO:
               granite-34b at 44 of 88 layers, phi3-mini-3.8b, internvl2-1b
               with its 256 vision frames, llama4-maverick at 2 of 48,
               arctic-480b at 2 of 35, jamba-1.5-large at 4 of 72; the
               cuts by the card's 80 GB), each through the serve entry point
               (8 requests, prompt 512, 32 generated tokens, bfloat16) -- the
               fifteenth main path, each run's counts zeroed just before and
               read just after its serve, equal to ``zoo_launches``:
               flash_attention once per attention sublayer in the prefill,
               fused_mlp once per dense MLP (arctic's dense residual
               included) per forward, selective_scan once per Mamba
               sublayer per forward; then its bfloat16 prefill logits
               through the kernels against the plain path (within
               PREFILL_TOL or CONTROL_FACTOR x a kernel-free reordering;
               the MoE runs' flipped routes), the hybrid cache's layout,
               the median of 3 prefills and a 31-step decode through each,
               its float32 logits at a cut depth (none for arctic), the
               peak device memory and the run's seconds;
22. layers     fused_conv3x3 vs its plain version at each of the 13 VGG-16
               conv shapes, with its time, the plain version's, a cuDNN
               yardstick's and the bound (float32: the smaller of the
               CUDA-core and the 3xTF32 bounds, both printed);
23. attention, mlp   flash_attention and fused_mlp vs their plain versions at
               the serving shapes of the six serving paths (llama4's chunk
               of 8192 also across a chunk boundary) and at the
               shapes of tests/test_kernels.py (masks, the planner's tiles,
               float32 and bfloat16), with the same four times, and every
               built tile at qwen3's serving shapes and (flash_attention
               with its logsumexp) its training shape; kernel phases time a
               launch over runs of CALLS launches and also one call alone
               (a call of SLOW_MS or more: both from single calls);
24. scan       selective_scan vs its plain version at falcon-mamba's and
               jamba's prefill and decode shapes, the shapes of tests/test_kernels.py and
               ragged ones, with its time, the plain version's and the bound
               (no single PyTorch call computes a selective scan); the
               decode rows also replay their CALLS launches from a CUDA graph
               (``device_ms``: the kernel without the host's launch path);
25. train      ``repro_torch.launch.train.run`` on qwen3-0.6b at full width
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
26. train_time ms per step, tokens/s and model TFLOP/s (6 N D + attention)
               over three more steps, and a profiled step's device idle
               share;
27. roofline   the cost tools (no kernel launches): ``launch.dryrun`` of
               qwen3-0.6b's train_4k and decode_32k cells on the 16x16 and
               2x16x16 meshes, traced on the host (resident GiB/device,
               bound, step >= ms, mfu <=); the roofline of phase train's
               step and of phase serve's prefill, walked over fake tensors at
               their shapes, against the measured medians: the
               reference-definition MFU of the measured step beside
               train_time's, and bound / measured, which fails the run
               above 1.0;
28. train_parity   one microbatch's loss and every gradient leaf through the
               kernels against the plain attention, bfloat16 at full depth
               (also against a kernel-free reordering) and float32 at 2
               layers;
29. train_kernel   flash_attention_bwd vs its plain version at qwen3's
               training shape, windowed, chunked, hd 64 non-causal GQA,
               ragged and float32 shapes, and at each microbatch shape of
               phase train_zoo (MQA 48/1, hd 96, window 1024 at 4096,
               cross attention 4096 x 1024, G 7 at 4352), two runs bit for
               bit at qwen3's, with its time, the plain version's, SDPA's
               backward and the bound; flash_attention with its logsumexp at
               each training shape;
30. train_sharded   the sharded training path -- the twelfth main path:
               qwen3-0.6b as in phase train, TRAIN_SHARDED's steps through
               ``make_train_step(grad_shardings=...)`` on a (1, 1) ("data",
               "model") NCCL mesh of this process (counts zeroed just before
               and read just after: flash_attention twice and
               flash_attention_bwd once per layer per microbatch) against as
               many single-device steps from the same state and batches:
               losses bit-equal, every parameter and moment bit-equal (or
               within TRAIN_PARITY_TOL, the differing leaves printed), ms a
               step and peak memory of both, one profiled step of each (the
               device's busy time; the sharded step's collective calls); 8
               steps of the int8-compressed step
               on a (1, 1, 1) ("pod", "data", "model") mesh (counts zeroed
               and read around them), losses finite and falling, every
               gradient leaf's payload handed to ``all_reduce`` as int8;
               ``resume_on_mesh`` of phase train's checkpoint, exactly the
               saved tensors; ``pipeline_apply`` at one stage, 6
               microbatches, bit-equal to the sequential result;
31. train_tp    the partitioned training path -- the thirteenth main path:
               qwen3-0.6b at full width and depth on a (1, 2) ("data",
               "model") mesh of two processes on the one card, joined by
               gloo (NCCL refuses two ranks on one GPU); each rank computes
               8 of the 16 heads and 1,536 of the 3,072 MLP columns.  Each
               rank first checks that gloo carries every collective of the
               path for CUDA tensors; then TRAIN_TP's steps through
               ``make_train_step(grad_shardings=...)`` and TRAIN_TP's
               prefills through ``make_prefill_step(shardings=...)``,
               counts zeroed just before and read just after each
               (flash_attention twice and flash_attention_bwd once per layer
               a step at 8 local heads; flash_attention and fused_mlp once
               per layer a prefill, at 8 heads and 1,536 columns), against
               the single-device steps and prefills from the same state: the
               first step's gradients (Adam's m after it) per leaf by
               relative L2 within TP_GRAD_TOL, the losses within
               TRAIN_PARITY_TOL, every parameter within what AdamW can move
               it, the logits within PREFILL_TOL; ms a step
               (warm steps apart from the first) and each rank's peak
               memory, one profiled step's device busy time and the host
               time spent in the collectives, the prefills' ms (cold, then
               warm);
32. train_zoo  seven more registry families trained at full width (TRAIN_ZOO:
               internvl2-1b with its 256 vision frames, seamless-m4t-large-v2
               24 + 24 layers, phi3-mini-3.8b, gemma3-27b's superblock of 6
               of 62 layers, granite-34b at 8 of 88, mixtral-8x7b at 2 of 32,
               falcon-mamba-7b at 24 of 64; the cuts by the card's 80 GB),
               each through ``launch.train.run`` (train_4k's run config and
               microbatches, "full" remat, the custom-VJP flash attention,
               TRAIN_ZOO_STEPS steps of two or four sequences of 4096 tokens)
               -- the sixteenth main path, each run's counts zeroed just
               before and read just after its training, equal to
               ``train_launches``: flash_attention twice and
               flash_attention_bwd once per attention sublayer per
               microbatch (none for falcon-mamba); the losses finite, ms a
               step over the warm steps, tokens/s, peak device memory; one
               microbatch's loss and gradients through the kernels against
               the plain attention (``grad_parity``) in bfloat16 at the
               run's depth and in float32 at a depth holding every sublayer
               kind (mixtral's plain path on the kernel path's expert
               choices, the flipped routes counted); every run's state freed
               before the next;
33. examples   the five twins ``examples/*_torch.py`` (quickstart,
               evaluate_design, serve_lm, train_lm at 100 of its 200
               steps, vgg_pipeline), each in a fresh interpreter on the card (its
               default device): exit 0, its output, its wall time; the VGG
               twin's fused forward launched fused_conv3x3 13 times;
34. the kernels line, then the result line.  Every kernel row's bytes and
    FLOPs (its bound) come from ``repro_torch.core.roofline.kernel_cost``.
    The kernels launched at the partitioned path's local shapes have their
    own entries (``"path": "train_tp"``), as have those of phases serve_zoo
    (``"path": "serve_zoo"``) and train_zoo (``"path": "train_zoo"``).
    Every phase prints its seconds (``phase seconds: ...``).

Usage: ``python3 chip_smoke.py [--seed N]`` from the root of a
checkout.  Exits non-zero, printing no result, without CUDA or outside a
checkout.  Writes every row to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import math
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
SLOW_MS = 5.0  # a kernel-phase call this slow is timed over single calls
SLOW_REPS = 3  # single calls timed of such a function
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
# flash_attention's bfloat16 shapes on the eighth to tenth and the
# fifteenth main paths: (label, (B, Sq, Skv, H, KV, hd), causal, window,
# chunk), with the launches a serve makes.  A serve_zoo run's rows are
# labelled "<arch>_prefill" (the kernels line sums them by that label).
SERVE_ATTENTION = [
    ("mixtral_prefill", (8, 512, 512, 32, 8, 128), True, 4096, 0),    # 16
    ("seamless_encoder", (8, 1024, 1024, 16, 16, 64), False, 0, 0),   # 24
    ("seamless_decoder", (8, 512, 512, 16, 16, 64), True, 0, 0),      # 24
    ("seamless_cross", (8, 512, 1024, 16, 16, 64), False, 0, 0),      # 24
    ("gemma3_local", (8, 1280, 1280, 32, 16, 128), True, 1024, 0),    # 5
    ("gemma3_global", (8, 1280, 1280, 32, 16, 128), True, 0, 0),      # 1
    ("tp_prefill", (8, 512, 512, 8, 4, 128), True, 0, 0),             # 28, 8 of 16 heads
    ("tp_train", (2, 2048, 2048, 8, 4, 128), True, 0, 0),             # 56 a train_tp step
    ("granite_prefill", (8, 512, 512, 48, 1, 128), True, 0, 0),       # 44: MQA, G 48
    ("phi3_prefill", (8, 512, 512, 32, 32, 96), True, 0, 0),          # 32: hd 96, mma.sync
    ("internvl2_prefill", (8, 768, 768, 14, 2, 64), True, 0, 0),      # 24: G 7, 256 frames
    ("llama4_prefill", (8, 512, 512, 40, 8, 128), True, 0, 8192),     # 2: one chunk
    ("arctic_prefill", (8, 512, 512, 56, 8, 128), True, 0, 0),        # 2
    ("jamba_prefill", (8, 512, 512, 64, 8, 128), True, 0, 0),         # 1
    # llama4's chunk of 8192 across a chunk boundary: no serve launches it
    # (a 512-token prompt never crosses one); the only launch of the real
    # chunk size.  The plain version's float32 scores take 24 GB.
    ("llama4_chunk", (1, 12288, 12288, 40, 8, 128), True, 0, 8192),   # 0
    # The benchmark's prefill cells (portbench/): jamba2-mini-prefill-long's
    # two attention layers (no RoPE, so the kernel's call is the same), 2
    # launches a prompt of each length; phi3-prefill-mix's longest batch,
    # 32 launches.  Plain scores past PLAIN_SCORES_BYTES go by query blocks.
    ("jamba2_prefill", (1, 4096, 4096, 32, 8, 128), True, 0, 0),       # 2 a prompt
    ("jamba2_prefill", (1, 8192, 8192, 32, 8, 128), True, 0, 0),       # 2
    ("jamba2_prefill", (1, 16384, 16384, 32, 8, 128), True, 0, 0),     # 2
    ("jamba2_prefill", (1, 32768, 32768, 32, 8, 128), True, 0, 0),     # 2
    ("phi3_prefill_mix", (8, 4032, 4032, 32, 32, 96), True, 0, 0),     # 32 a batch
]
# The plain attention's float32 scores are taken whole up to this many
# bytes (llama4_chunk's 24.2 GB); past it, PLAIN_QUERY_BLOCK queries at a
# time (8.6 GB of scores a block at 32,768 keys and 32 heads).
PLAIN_SCORES_BYTES = 24 << 30
PLAIN_QUERY_BLOCK = 2048
# fused_mlp's bfloat16 shapes there: (label, (T, d, ff, act)); a serve_zoo
# run's rows are "<arch>_prefill" and "<arch>_decode".
SERVE_MLP = [
    ("seamless_encoder", (8192, 1024, 8192, "relu")),   # 24 a serve
    ("seamless_prefill", (4096, 1024, 8192, "relu")),   # 24
    ("seamless_decode", (8, 1024, 8192, "relu")),       # 24 a step: 744
    ("gemma3_prefill", (10240, 5376, 21504, "geglu")),  # 6
    ("gemma3_decode", (8, 5376, 21504, "geglu")),       # 6 a step: 186
    ("tp_prefill", (4096, 1024, 1536, "swiglu")),       # 28, 1,536 of 3,072 columns
    ("granite_prefill", (4096, 6144, 24576, "gelu")),   # 44: no w3
    ("granite_decode", (8, 6144, 24576, "gelu")),       # 44 a step: 1,364
    ("phi3_prefill", (4096, 3072, 8192, "swiglu")),     # 32
    ("phi3_decode", (8, 3072, 8192, "swiglu")),         # 32 a step: 992
    ("internvl2_prefill", (6144, 896, 4864, "swiglu")),  # 24: 256 frames + 512 tokens
    ("internvl2_decode", (8, 896, 4864, "swiglu")),     # 24 a step: 744
    ("llama4_prefill", (4096, 5120, 8192, "swiglu")),   # 1: layer 0's dense MLP
    ("llama4_decode", (8, 5120, 8192, "swiglu")),       # 1 a step: 31
    ("arctic_prefill", (4096, 7168, 4864, "swiglu")),   # 2: the dense residual
    ("arctic_decode", (8, 7168, 4864, "swiglu")),       # 2 a step: 62
    ("jamba_prefill", (4096, 8192, 24576, "swiglu")),   # 2
    ("jamba_decode", (8, 8192, 24576, "swiglu")),       # 2 a step: 62
    # the benchmark's prefill cells at their most rows: jamba2-mini-prefill-
    # long's dense layers on a 32,768-token prompt, phi3-prefill-mix's batch
    # of 8 x 4,032
    ("jamba2_prefill", (32768, 4096, 14336, "swiglu")),    # 8 a prompt
    ("phi3_prefill_mix", (32256, 3072, 8192, "swiglu")),  # 32 a batch
]
# selective_scan's shapes in the benchmark's prefill cells, with the state
# in and out: jamba2-mini-prefill-long's Mamba layers take a prompt in
# chunks of time of ssm.time_chunk(1, 8192, 16) = 8,192 steps, each call
# starting from the state the one before returned: 14 launches a chunk.
SERVE_SCAN = [
    ("jamba2_prefill", (1, 8192, 8192, 16)),  # 56 a 32,768-token prompt
]
# The fifteenth main path, phase serve_zoo: the registry's six other
# families at full width through the serve entry point, 8 requests, prompt
# 512 (internvl2's 256 vision frames before it), 32 generated tokens,
# bfloat16.  "n_layers": the depth where the card's 80 GB cut it (the
# layers kept cover every sublayer kind of the model), bfloat16 weights by
# ``cfg.param_counts()``: granite-34b 44 of 88 (33.96 GB; all 88 hold
# 67.32, too tight beside the plain path's float32 copies and the
# script's time), llama4-maverick 2 of 48 (layer 0 chunked attention +
# dense MLP, layer 1 chunked + the 128-expert MoE; 34.79 GB, 4 layers 67.5),
# arctic 2 of 35 (54.9 GB), jamba 4 of 72 (mamba + dense, mamba + MoE,
# mamba + dense, attention + MoE: K2, K3 and K4 in one trunk; 44.97 GB).
# "f32_layers": the float32 comparison's depth (None: arctic, whose one
# float32 layer holds 55 GB; its kernels are held alone in phases
# attention and mlp).
SERVE_ZOO = [
    {"arch": "granite", "requests": 8, "prompt_len": 512, "gen": 32, "n_layers": 44,
     "f32_layers": 4},
    {"arch": "phi3", "requests": 8, "prompt_len": 512, "gen": 32, "f32_layers": 8},
    {"arch": "internvl2", "requests": 8, "prompt_len": 512, "gen": 32, "f32_layers": 24},
    {"arch": "llama4", "requests": 8, "prompt_len": 512, "gen": 32, "n_layers": 2,
     "f32_layers": 1},
    {"arch": "arctic", "requests": 8, "prompt_len": 512, "gen": 32, "n_layers": 2,
     "f32_layers": None},
    {"arch": "jamba", "requests": 8, "prompt_len": 512, "gen": 32, "n_layers": 4,
     "f32_layers": 1},
]
# The timed prefills of a serve_zoo run, in turns: 3 a path (the median).
ZOO_ORDER = ("kernels", "plain", "plain", "kernels", "kernels", "plain")

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
# against the plain attention and scan (relative L2 per leaf).  bfloat16 at full
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
# causal, window, chunk); "train" is qwen3's training microbatch, the
# "<arch>..._train" rows phase train_zoo's microbatches (train_zoo_shapes),
# each with a row of K2's forward with its logsumexp at the same shape.
TRAIN_KERNEL_CASES = [
    ("train", (4, 4096, 4096, 16, 8, 128), "bfloat16", True, 0, 0),
    ("train_tp", (2, 2048, 2048, 8, 4, 128), "bfloat16", True, 0, 0),
    ("window", (2, 1024, 1024, 16, 8, 128), "bfloat16", True, 256, 0),
    ("chunk", (2, 1024, 1024, 16, 8, 128), "bfloat16", True, 0, 256),
    ("hd64_noncausal_gqa4", (2, 512, 512, 16, 4, 64), "bfloat16", False, 0, 0),
    ("ragged", (2, 1000, 1000, 8, 4, 96), "bfloat16", True, 0, 0),
    ("float32", (2, 512, 512, 16, 8, 128), "float32", True, 0, 0),
    ("float32_ragged", (1, 333, 333, 4, 2, 64), "float32", True, 0, 0),
    ("internvl2_train", (2, 4352, 4352, 14, 2, 64), "bfloat16", True, 0, 0),  # G 7
    ("seamless_encoder_train", (2, 1024, 1024, 16, 16, 64), "bfloat16", False, 0, 0),
    ("seamless_decoder_train", (2, 4096, 4096, 16, 16, 64), "bfloat16", True, 0, 0),
    ("seamless_cross_train", (2, 4096, 1024, 16, 16, 64), "bfloat16", False, 0, 0),
    ("phi3_train", (1, 4096, 4096, 32, 32, 96), "bfloat16", True, 0, 0),  # mma.sync
    ("gemma3_local_train", (1, 4096, 4096, 32, 16, 128), "bfloat16", True, 1024, 0),
    ("gemma3_global_train", (1, 4096, 4096, 32, 16, 128), "bfloat16", True, 0, 0),
    ("granite_train", (1, 4096, 4096, 48, 1, 128), "bfloat16", True, 0, 0),  # MQA
    ("mixtral_train", (2, 4096, 4096, 32, 8, 128), "bfloat16", True, 4096, 0),
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


class PhaseClock:
    """The seconds of each phase, printed as it ends: the time since the
    previous phase ended (or the run began)."""

    def __init__(self):
        self.mark = time.perf_counter()
        self.seconds = {}

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.mark
        self.mark = now
        print(f"phase seconds: {phase} {self.seconds[phase]:.1f} s")


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
    call's host cost included, the rows' ``call_ms``).  A function whose
    one call takes SLOW_MS or more (the plain versions at the largest
    shapes, the largest MLP launches) has both from the median of SLOW_REPS
    single calls: a launch's host cost is noise beside it, and REPS x
    (CALLS + 1) calls of a plain version at 50-150 ms would take minutes."""
    probe = {k: event_ms(torch, fn)[0] for k, fn in fns.items()}
    fast = {k: fn for k, fn in fns.items() if probe[k] < SLOW_MS}
    slow = {k: fn for k, fn in fns.items() if probe[k] >= SLOW_MS}
    ms, one = {}, {}
    if fast:
        ms.update(time_ms(torch, fast, REPS, CALLS))
        one.update(time_ms(torch, fast, REPS))
    if slow:
        single = time_ms(torch, slow, SLOW_REPS)
        ms.update(single)
        one.update(single)
    return ms, one


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


def serialized_wgmma(log: str) -> list:
    """The kernels (mangled names) of an ``nvcc -Xptxas -v`` log where
    ptxas notes that it serializes their wgmma (C7515 / C7520)."""
    return [line.split("in the function", 1)[-1].strip(" '") for line in log.splitlines()
            if "wgmma.mma_async instructions are serialized" in line]


def phase_build() -> dict:
    """Build the five kernel libraries from the checkout's sources, one
    nvcc each, all started together.  For the attention backward, each
    instantiation's registers, spills and HMMA / HGMMA instructions; fails
    if one that training launches has no HGMMA or spills.  For K2 and K3,
    whose bfloat16 bodies run on the tensor cores: each bf16
    instantiation's registers and spills (``-Xptxas -v``) and its HMMA /
    HGMMA instructions in the SASS (``cuobjdump -sass``); fails if a bf16
    instantiation that serving launches has none, and if K2's wgmma
    instantiations that serving and training launch (``default_tile`` at
    their lengths) have no HGMMA, spill or have their wgmma serialized.
    For K1: its float32 body (3xTF32 on wgmma) at each tile, failing if an
    instantiation the VGG path launches has no HGMMA, spills or has its
    wgmma serialized; its bfloat16 body (mma.sync), failing if one has no
    HMMA or spills; its weight-prep and input-staging kernels, failing if
    one spills."""
    import torch

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
    bm, bf = fused_mlp.default_tile(SERVE["requests"] * SERVE["prompt_len"])
    dm, df = fused_mlp.default_tile(SERVE["requests"])
    serving = {  # the bf16 instantiations the serving and training paths launch
        # K2's wgmma body: head dims 128 and 64 at the serving lengths'
        # tile (qwen3, mixtral, gemma3's superblock; seamless), 128 at the
        # training length's (with and without lse: one instantiation)
        fused_attention.KERNEL.name: [
            f"flash_attention_wgmma_kernelILi{hd}ELi{t[0]}ELi{t[1]}E"
            for hd, t in ((128, fused_attention.default_tile(128, torch.bfloat16, SERVE["prompt_len"])),
                          (64, fused_attention.default_tile(64, torch.bfloat16, SERVE["prompt_len"])),
                          (128, fused_attention.default_tile(128, torch.bfloat16, TRAIN_RUN["seq"])))],
        fused_mlp.KERNEL.name: [f"fused_mlp_mma_prefill_kernelILi{bm}ELi{bf}ELb1E",
                                f"fused_mlp_mma_decode_kernelILi{dm}ELi{df}ELb1E"],
    }
    for kernel, built in zip(kernels, builds):
        if kernel.name not in serving:
            continue
        report = builder.ptxas_report(built.log)
        sass = builder.sass_counts(built.path)
        serialized = serialized_wgmma(built.log)
        bf16 = sorted(n for n in sass if "_mma_" in n or "_wgmma_" in n)
        f32 = [n for n in sass if "_f32_kernel" in n]
        for want in serving[kernel.name]:
            check(any(want in n for n in bf16),
                  f"{built.path.name}: no bf16 kernel {want} in the SASS")
        for name in bf16:
            ops, ptx = sass[name], report.get(name, {})
            body = "wgmma" if "_wgmma_" in name else "mma"
            short = f"{body} " + name.split(f"_{body}_", 1)[1].split("EEv", 1)[0]
            serve = any(w in name for w in serving[kernel.name])
            serial = any(name in f for f in serialized)
            spills = (ptx.get("spill_stores"), ptx.get("spill_loads"))
            out["tensor_core"][f"{kernel.name}:{short}"] = {
                **ops, **ptx, "serving": serve, "wgmma_serialized": serial}
            print(f"  {kernel.name} bf16 {short}{' (serving)' if serve else ''}: "
                  f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; {ptx.get('registers')} "
                  f"registers, spills {spills[0]} / {spills[1]} bytes"
                  + ("; ptxas serializes its wgmma" if serial else ""))
            check(not serve or ops["HMMA"] + ops["HGMMA"] > 0,
                  f"{kernel.name}'s serving instantiation {short} has no tensor-core "
                  "instruction in its SASS")
            if serve and body == "wgmma":
                check(ops["HGMMA"] > 0, f"{kernel.name}'s serving instantiation {short} "
                      "has no HGMMA")
                check(not any(spills), f"{kernel.name}'s serving instantiation {short} "
                      f"spills {spills} bytes")
                check(not serial, f"ptxas serializes the wgmma of {kernel.name}'s serving "
                      f"instantiation {short}")
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
    serialized = serialized_wgmma(bwd.log)
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
    # K1: the float32 body (3xTF32 on wgmma) at each tile the VGG path
    # launches (batch 8: tile 16, and tile 8 at 14x14) must hold HGMMA, spill
    # nothing and keep its wgmma asynchronous; the bfloat16 body (mma.sync,
    # phase layers) HMMA and no spill; the weight prep and the input staging
    # no spill.
    import re

    from repro_torch.core.ir import VGG16_CONV_PLAN

    conv = builds[kernels.index(fused_conv.KERNEL)]
    report = builder.ptxas_report(conv.log)
    sass = builder.sass_counts(conv.path)
    serialized = serialized_wgmma(conv.log)
    vgg_tiles = {fused_conv.choose_tile(BATCH, hw, hw, cout)
                 for _, _, cout, hw, _ in VGG16_CONV_PLAN}
    bodies = {n: re.search(r"fused_conv3x3_(f32|bf16)_kernelILi(\d+)E", n) for n in sass}
    bodies = {n: (m.group(1), int(m.group(2))) for n, m in bodies.items() if m}
    aux = {n: kind for kind in ("prep_weights", "stage_input") for n in sass
           if f"fused_conv3x3_{kind}_kernel" in n}
    for dname in ("f32", "bf16"):
        check(sorted(t for d, t in bodies.values() if d == dname) == sorted(fused_conv.TILES),
              f"{conv.path.name}: the {dname} kernels in the SASS are not one a tile "
              f"{fused_conv.TILES}")
    check(sorted(aux.values()) == ["prep_weights", "stage_input"],
          f"{conv.path.name}: the weight-prep and staging kernels in the SASS are "
          f"{sorted(aux.values())}")
    for name in sorted(bodies, key=lambda n: bodies[n]) + sorted(aux):
        ops, ptx = sass[name], report.get(name, {})
        dname, tile = bodies.get(name, (aux.get(name), None))
        vgg = dname == "f32" and tile in vgg_tiles
        serial = any(name in f for f in serialized)
        spills = (ptx.get("spill_stores"), ptx.get("spill_loads"))
        what = {"f32": f"float32 3xTF32 wgmma tile {tile}", "bf16": f"bfloat16 mma.sync tile {tile}",
                "prep_weights": "float32 weight prep", "stage_input": "float32 input staging"}[dname]
        out["tensor_core"][f"{fused_conv.KERNEL.name}:{dname}:{tile}"] = {
            **ops, **ptx, "vgg_path": vgg, "wgmma_serialized": serial}
        print(f"  {fused_conv.KERNEL.name} {what}{' (VGG path)' if vgg else ''}: "
              f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; {ptx.get('registers')} registers, "
              f"spills {spills[0]} / {spills[1]} bytes"
              + ("; ptxas serializes its wgmma" if serial else ""))
        check(not any(spills), f"fused_conv3x3 {what} spills {spills} bytes")
        if dname == "bf16":
            check(ops["HMMA"] > 0, f"fused_conv3x3 {what} has no HMMA in its SASS")
        if vgg:
            check(ops["HGMMA"] > 0, f"fused_conv3x3 {what} has no HGMMA in its SASS")
            check(not serial, f"ptxas serializes the wgmma of fused_conv3x3 {what}")
    check(vgg_tiles <= {t for d, t in bodies.values() if d == "f32"},
          f"the VGG path's tiles {sorted(vgg_tiles)} are not all built")
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


# ---------------------------------------------------------------------------
# Training VGG-16 (models/vgg.py's functional half) and the examples' twins
# ---------------------------------------------------------------------------

# The VGG-16 training run: the paper's model at its published size, 10
# SGD+momentum steps as examples/vgg_pipeline.py takes them.
VGG_TRAIN = {"in_hw": 224, "n_classes": 1000, "batch": BATCH, "steps": 10,
             "lr": 1e-3, "momentum": 0.9}
# The first step's float32 gradients against the same step in float64 on the
# card, relative L2 per leaf.  The float64 step replays the float32 forward's
# gates (each ReLU's mask, each 2x2 pool's argmax): a float64 forward of its
# own flips the gates of the few units whose pre-activation lies within
# float32's rounding of zero, and on random labels a gradient is a sum of
# terms that mostly cancel, so those flips alone move a conv leaf by 0.0089
# (conv_w[0]), TF32 or not.  Against the replay (seed 0, NVIDIA H100 80GB
# HBM3, 700.00 W) the sound step is within 2.16e-5 (conv_w[1], its weight
# gradient a sum over 8 x 224 x 224 pixels; median 1.2e-6) and a step with
# TF32 on in the backward 1.32e-3 (conv_w[3]; median 8.2e-4).  1e-4 sits
# 4.6x above the one and 13x below the other.
VGG_GRAD_TOL = 1e-4
# The five example twins run on the card by phase examples, with the
# arguments each is given there: train_lm at 100 of its 200 steps (its
# failure at step 50, after the step-49 checkpoint), since at 200 (37.5 s)
# the phase, then one twin after the other, took 98.7 s, past its 90 s.
EXAMPLES = {"quickstart": [], "evaluate_design": [], "serve_lm": [],
            "train_lm": ["--steps", "100"], "vgg_pipeline": []}
EXAMPLE_TIMEOUT_S = 300


def vgg_forward_flops(in_hw: int, n_classes: int) -> float:
    """FLOPs of one image's VGG-16 forward (2 per multiply-add): the 13
    convolutions at the plan's 224x224 frames and the classifier."""
    from repro_torch.core.ir import VGG16_CONV_PLAN

    conv = sum(2 * 9 * n_in * n_out * hw * hw for _n, n_in, n_out, hw, _p in VGG16_CONV_PLAN)
    s = in_hw // 32
    return float(conv + 2 * (512 * s * s * 4096 + 4096 * 4096 + 4096 * n_classes))


def _vgg_loss_grads(torch, VGG, params: dict, batch: dict) -> tuple:
    """(loss, the gradient of every leaf of ``params`` in tree order):
    ``VGG.loss_fn`` through autograd on detached copies of the leaves."""
    from torch.utils import _pytree as pytree

    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = VGG.loss_fn(pytree.tree_unflatten(leaves, spec), batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def _vgg_gates(torch, VGG, params: dict, x) -> tuple:
    """The float32 forward's discrete choices, from the ops ``loss_fn``
    runs (TF32 off): every ReLU's mask (its output > 0, as ReLU's backward
    reads it) and every 2x2 pool's argmax indices (None where unpooled)."""
    import torch.nn.functional as F

    from repro_torch.core.ir import VGG16_CONV_PLAN
    from repro_torch.kernels import ref

    masks, pools = [], []
    with torch.no_grad(), ref.no_tf32():
        for i, (_n, _ci, _co, _hw, pooled) in enumerate(VGG16_CONV_PLAN):
            x = VGG.conv_bn_relu(x, {"w": params["conv_w"][i], "b": params["conv_b"][i]})
            masks.append(x > 0)
            idx = None
            if pooled:
                y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), 2, return_indices=True)
                x = y.permute(0, 2, 3, 1)
            pools.append(idx)
        x = x.reshape(x.shape[0], -1)
        for w, b in zip(params["fc_w"][:2], params["fc_b"][:2]):
            x = torch.relu(x @ w + b)
            masks.append(x > 0)
    return masks, pools


def _vgg_gated_loss(torch, params: dict, batch: dict, masks: list, pools: list):
    """VGG-16's loss with every ReLU and pool replaced by the given gates
    (:func:`_vgg_gates`), in the dtype of ``params``: the same linear piece
    of the network as the forward the gates came from."""
    import torch.nn.functional as F

    x = batch["images"]
    for i, (w, b) in enumerate(zip(params["conv_w"], params["conv_b"])):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
        y = (y.permute(0, 2, 3, 1) + b) * masks[i]
        if pools[i] is not None:
            B, H, W, C = y.shape
            flat = y.permute(0, 3, 1, 2).reshape(B, C, H * W)
            y = flat.gather(2, pools[i].reshape(B, C, -1)).reshape(
                B, C, H // 2, W // 2).permute(0, 2, 3, 1)
        x = y
    x = x.reshape(x.shape[0], -1)
    for i, (w, b) in enumerate(zip(params["fc_w"], params["fc_b"])):
        x = x @ w + b
        if i < 2:
            x = x * masks[len(params["conv_w"]) + i]
    logp = torch.log_softmax(x, dim=-1)
    return -torch.gather(logp, -1, batch["labels"][:, None]).mean()


def phase_vgg_train(torch, spec, card: str, seed: int) -> dict:
    """VGG-16 at 224x224 x 3 with 1,000 classes, float32, trained through
    ``models.vgg.init_params`` / ``loss_fn`` and autograd for VGG_TRAIN's
    SGD+momentum steps with cuDNN's TF32 off in forward and backward; the
    first step's gradients against float64 (and, to show the bound catches
    it, against a step with TF32 on in the backward); the trained
    parameters' forward through fused_conv3x3 against the plain forward."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import fused_conv, ops, ref
    from repro_torch.models import vgg as VGG

    run = VGG_TRAIN
    B, hw, n_cls = run["batch"], run["in_hw"], run["n_classes"]
    params = VGG.init_params(torch.Generator(device="cuda").manual_seed(seed),
                             in_hw=hw, n_classes=n_cls)
    bgen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def next_batch():
        return {"images": torch.randn((B, hw, hw, 3), generator=bgen, device="cuda"),
                "labels": torch.randint(0, n_cls, (B,), generator=bgen, device="cuda")}

    # the first step's gradients: float32 (TF32 off, then TF32 on in the
    # backward, as autograd runs it when the caller does not scope it)
    # against float64 replaying the float32 forward's gates, and against a
    # float64 step of its own (printed)
    batch0 = next_batch()
    with ref.no_tf32():
        _, g32 = _vgg_loss_grads(torch, VGG, params, batch0)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, g_tf32 = _vgg_loss_grads(torch, VGG, params, batch0)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    masks, pools = _vgg_gates(torch, VGG, params, batch0["images"])
    flat64, spec64 = pytree.tree_flatten(pytree.tree_map(lambda t: t.double(), params))
    leaves64 = [p.requires_grad_(True) for p in flat64]
    batch64 = {"images": batch0["images"].double(), "labels": batch0["labels"]}
    g64 = torch.autograd.grad(_vgg_gated_loss(
        torch, pytree.tree_unflatten(leaves64, spec64), batch64, masks, pools), leaves64)
    del masks, pools, leaves64
    _, g64_own = _vgg_loss_grads(torch, VGG, pytree.tree_unflatten(flat64, spec64), batch64)
    sound = _rel_l2(torch, [g.double() for g in g32], g64)
    tf32 = _rel_l2(torch, [g.double() for g in g_tf32], g64)
    own = _rel_l2(torch, [g.double() for g in g32], g64_own)
    del g32, g_tf32, g64, g64_own, flat64
    names = [f"{k}[{i}]" for k, v in params.items() for i in range(len(v))]

    def worst(rel):
        i = max(range(len(rel)), key=rel.__getitem__)
        return f"max {rel[i]:.6g} ({names[i]}), median {statistics.median(rel):.6g}"

    print(f"phase vgg_train gradients: the first step, float32 against float64 on the "
          f"card with the float32 forward's gates, relative L2 per leaf over "
          f"{len(sound)} leaves: TF32 off {worst(sound)}; TF32 on in the backward "
          f"{worst(tf32)}; bound {VGG_GRAD_TOL}; against a "
          f"float64 step with gates of its own: {worst(own)}")
    check(max(sound) <= VGG_GRAD_TOL,
          f"VGG-16's float32 gradients differ from float64 by {max(sound)} > {VGG_GRAD_TOL}")
    check(max(tf32) > VGG_GRAD_TOL,
          f"a backward in TF32 stays within VGG_GRAD_TOL = {VGG_GRAD_TOL} "
          f"(max {max(tf32)}): the bound would not catch it")

    # the training run: every step's forward and backward with TF32 off
    flat = pytree.tree_leaves(params)
    momentum = [torch.zeros_like(p) for p in flat]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for step in range(run["steps"]):
        batch = batch0 if step == 0 else next_batch()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        with ref.no_tf32():
            loss, grads = _vgg_loss_grads(torch, VGG, params, batch)
        with torch.no_grad():
            for p, m, g in zip(flat, momentum, grads):
                m.mul_(run["momentum"]).add_(g)
                p.sub_(run["lr"] * m)
        e1.record()
        e1.synchronize()
        del grads
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses),
          f"non-finite VGG-16 training losses: {losses}")
    ms = statistics.median(step_ms[1:])
    fwd = vgg_forward_flops(hw, n_cls)
    step_flops = 3 * fwd * B
    bound = spec.compute_seconds(step_flops, 4) * 1e3
    print(f"phase vgg_train: VGG-16 {hw}x{hw}, {n_cls} classes, batch {B}, float32, "
          f"TF32 off in forward and backward, {run['steps']} SGD+momentum steps (lr "
          f"{run['lr']}, momentum {run['momentum']}) through loss_fn and autograd: "
          f"{ms:.4f} ms a step (median of {len(step_ms) - 1} warm steps; the first "
          f"{step_ms[0]:.4f}), {B / ms * 1e3:.6g} images/s, {step_flops / ms / 1e9:.6g} "
          f"TFLOP/s model (3 x {fwd / 1e9:.6g} GFLOP an image = {step_flops / 1e9:.6g} "
          f"GFLOP a step), bound {bound:.4f} ms at {spec.peak_fp32_flops / 1e12:g} "
          f"TFLOP/s (CUDA cores; share {bound / ms:.4f}), peak memory "
          f"{peak / 2**30:.4f} GiB; {card}")
    print(f"phase vgg_train losses: {losses}")

    # the trained parameters' forward through the kernel vs the plain one
    x = next_batch()["images"]
    before = fused_conv.fused_conv3x3.launches
    with torch.inference_mode():
        y = VGG.forward(params, x, fused_conv_fn=ops.fused_conv_fn())
        torch.cuda.synchronize()
        launched = fused_conv.fused_conv3x3.launches - before
        y_plain = VGG.forward(params, x)
    check(launched == 13, f"the trained forward launched fused_conv3x3 {launched} "
          "times, not 13")
    check(bool(torch.isfinite(y).all()), "non-finite logits of the trained VGG-16")
    err = float((y - y_plain).abs().max())
    scale = float(y_plain.abs().max())
    check(err <= LOGIT_TOL * scale,
          f"the trained VGG-16's fused logits differ from plain by {err} > "
          f"{LOGIT_TOL} x {scale}")
    print(f"phase vgg_train forward: the trained parameters through fused_conv3x3 "
          f"({launched} launches), logits max |fused - plain| = {err:.6g} (max |logit| "
          f"{scale:.6g}, tolerance {LOGIT_TOL} x max)")
    return {"ms_per_step": ms, "step_ms": step_ms, "images_per_s": B / ms * 1e3,
            "model_tflops": step_flops / ms / 1e9, "step_gflop": step_flops / 1e9,
            "bound_ms": bound, "peak_bytes": peak, "losses": losses,
            "grad_rel_l2_max": max(sound), "grad_rel_l2_tf32_max": max(tf32),
            "grad_rel_l2_own_gates_max": max(own),
            "grad_rel_l2": dict(zip(names, sound)),
            "grad_rel_l2_tf32": dict(zip(names, tf32)),
            "grad_rel_l2_own_gates": dict(zip(names, own)),
            "launches": launched, "max_abs_err": err, "max_abs_logit": scale,
            "card": card}


def phase_examples(card: str) -> dict:
    """Each twin in ``examples/*_torch.py`` in a fresh interpreter with its
    default device (the card), the five at once: exit 0, its output, its
    wall time from the common start (one after the other they took ~96 s,
    PERF.md).  A twin still running after EXAMPLE_TIMEOUT_S fails the run;
    every twin still running then is stopped."""
    import re

    rows, runs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        t0 = time.perf_counter()
        try:
            for name, args in EXAMPLES.items():
                out = open(Path(tmp) / f"{name}.out", "w+")
                err = open(Path(tmp) / f"{name}.err", "w+")
                proc = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"), *args],
                    cwd=ROOT, stdout=out, stderr=err, text=True)
                runs[name] = {"proc": proc, "out": out, "err": err, "wall": None}
            while any(r["wall"] is None for r in runs.values()):
                for r in runs.values():
                    if r["wall"] is None and r["proc"].poll() is not None:
                        r["wall"] = time.perf_counter() - t0
                check(time.perf_counter() - t0 < EXAMPLE_TIMEOUT_S,
                      f"examples still running after {EXAMPLE_TIMEOUT_S} s: "
                      f"{[n for n, r in runs.items() if r['wall'] is None]}")
                time.sleep(0.05)
        finally:
            for r in runs.values():
                if r["proc"].poll() is None:
                    r["proc"].kill()
                    r["proc"].wait()
        for name, r in runs.items():
            r["out"].seek(0)
            r["err"].seek(0)
            stdout, stderr = r["out"].read(), r["err"].read()
            r["out"].close()
            r["err"].close()
            for line in stdout.splitlines():
                print(f"  {name}_torch | {line}")
            check(r["proc"].returncode == 0,
                  f"examples/{name}_torch.py exited {r['proc'].returncode}: {stderr[-3000:]}")
            args = EXAMPLES[name]
            given = f" {' '.join(args)} (cut from its default)" if args else ""
            print(f"phase examples: examples/{name}_torch.py{given} exit 0 in "
                  f"{r['wall']:.3f} s (wall from the five's common start, interpreter "
                  f"start included); {card}")
            rows[name] = {"args": args, "seconds": r["wall"], "stdout": stdout}
    found = re.search(r"\((\d+) fused_conv3x3 launches\)", rows["vgg_pipeline"]["stdout"])
    check(found is not None and int(found.group(1)) == 13,
          "vgg_pipeline_torch.py's fused forward did not launch fused_conv3x3 13 times")
    return rows


def phase_layers(torch, spec, seed: int) -> list:
    """fused_conv3x3 vs its plain version at each VGG-16 conv shape; the
    bound is the larger of the bytes over ``spec``'s memory rate and the
    operations over a peak rate: bfloat16 FLOPs at the tensor cores'
    bfloat16 rate; float32 the smaller of FLOPs at the CUDA cores' rate and
    3 x FLOPs at the tensor cores' TF32 rate (3xTF32, the kernel's
    float32-exact route), both printed."""
    import torch.nn.functional as F

    from repro_torch.core import roofline as RL
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
            kc = RL.kernel_cost("fused_conv3x3", x=tuple(x.shape), cout=cout, pool=pool,
                                itemsize=es)
            n_bytes, flops = kc.bytes, kc.flops
            t_bytes = spec.memory_seconds(n_bytes) * 1e3
            t_cores, t_3x = conv_op_bounds(spec, flops, es)
            t_ops = t_cores if t_3x is None else min(t_cores, t_3x)
            geo = fused_conv.launch_geometry(batch, hw, hw, cin, cout, dtype)
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
    """A serving run's command line (``--layers`` where the run cuts the
    depth)."""
    cut = ["--layers", str(run["n_layers"])] if "n_layers" in run else []
    return ["--arch", run["arch"], "--full", *cut, "--requests", str(run["requests"]),
            "--prompt-len", str(run["prompt_len"]), "--gen", str(run["gen"]),
            "--seed", str(seed)]


def serve_config(run: dict):
    """A serving or training run's config at full width: the registry's,
    its depth cut to ``run["n_layers"]`` where the run says so."""
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
    depth, or at ``run["n_layers"]`` (``--layers``)."""
    from repro_torch.configs import resolve
    from repro_torch.launch import serve

    full = resolve(run["arch"])
    cfg = serve_config(run)
    t0 = time.perf_counter()
    ids = serve.main(serve_argv(run, seed))
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


def plain_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    chunk: int = 0):
    """``ref.flash_attention_ref``; where its float32 scores would pass
    PLAIN_SCORES_BYTES, the same materialised-scores softmax taken
    PLAIN_QUERY_BLOCK queries at a time, each block's scores over every
    key under the same mask."""
    import math

    import torch

    from repro_torch.kernels import ref
    from repro_torch.models.layers import NEG_INF

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if B * H * Sq * Skv * 4 <= PLAIN_SCORES_BYTES:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, chunk=chunk)
    idx = torch.arange(H, device=q.device) // (H // KV)
    kr, vr = (t.index_select(2, idx).float() for t in (k, v))
    ok = ref._visible(Sq, Skv, causal, window, chunk, q.device)
    out = torch.empty_like(q)
    for i in range(0, Sq, PLAIN_QUERY_BLOCK):
        j = min(Sq, i + PLAIN_QUERY_BLOCK)
        s = torch.einsum("bqhd,bchd->bhqc", q[:, i:j].float(), kr) * (1.0 / math.sqrt(hd))
        s += torch.where(ok[i:j], 0.0, NEG_INF)
        out[:, i:j] = torch.einsum("bhqc,bchd->bqhd", torch.softmax(s, dim=-1), vr).to(q.dtype)
        del s
    return out


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


def _routed(run, route):
    """``run()`` with ``moe.route_topk`` replaced by ``route(real, logits,
    top_k, renormalize)``, restored after."""
    from repro_torch.models import moe as MOE

    real = MOE.route_topk
    MOE.route_topk = lambda logits, top_k, renormalize=True: route(real, logits, top_k,
                                                                   renormalize)
    try:
        return run()
    finally:
        MOE.route_topk = real


def recorded_routes(run) -> tuple:
    """(``run()``, the top-k expert indices of each of its MoE routings, in
    call order)."""
    seen = []

    def route(real, logits, top_k, renormalize):
        gates, idx, probs = real(logits, top_k, renormalize=renormalize)
        seen.append(idx)
        return gates, idx, probs

    return _routed(run, route), seen


def replayed_routes(routes: list, run):
    """``run()`` with its MoE routings taking the expert indices of
    ``routes`` (as :func:`recorded_routes` gives them, in call order), each
    token's gates from this run's own router probabilities at them: a run
    that differs from the recorded one by rounding alone then differs by a
    continuous function of it, not by whole experts where a top-k choice
    between two near-tied experts flips."""
    import torch

    todo = iter(routes)

    def route(real, logits, top_k, renormalize):
        _, _, probs = real(logits, top_k, renormalize=renormalize)
        idx = next(todo)
        gates = probs.gather(-1, idx)
        if renormalize:
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return gates, idx, probs

    return _routed(run, route)


def count_flips(a: list, b: list) -> tuple:
    """([token routes whose top-k expert set differs between the routings
    ``a`` and ``b``, one count per MoE layer], routes in all)."""
    per_layer = [int((x.sort(dim=-1).values != y.sort(dim=-1).values).any(dim=-1).sum())
                 for x, y in zip(a, b)]
    return per_layer, sum(x[..., 0].numel() for x in a)


def route_flips(run_a, run_b) -> tuple:
    """:func:`count_flips` of ``run_a()``'s and ``run_b()``'s routings."""
    return count_flips(recorded_routes(run_a)[1], recorded_routes(run_b)[1])


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
    versions (3 rounds of kernels, plain, plain, kernels prefills; a decode
    of ``gen - 1`` steps after each prefill of the first round only: the
    other rounds' 8 decodes took about a minute over the four serve_*_time
    phases, PERF.md), a profiled prefill and four decode steps, and the
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
        for rnd in range(3):
            for name in ("kernels", "plain", "plain", "kernels"):
                ms, (logits, cache) = event_ms(torch, lambda: prefill(params, cfg, name))
                samples[f"{name}_prefill"].append(ms)
                if rnd:  # a path's decode ms: the median of the first round's 2
                    del logits, cache
                    continue
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


def zoo_launches(cfg, gen: int) -> dict:
    """The launches one serve of ``cfg`` (a prefill and ``gen - 1`` decode
    steps) makes: flash_attention once per attention sublayer in the
    prefill (a decode step's one query attends in torch ops), fused_mlp
    once per dense MLP per forward (arctic's dense residual beside its
    experts is one; the experts are plain products), selective_scan once
    per Mamba sublayer per forward."""
    kinds = cfg.sublayer_kinds(0, cfg.n_layers)
    attn = sum(mixer != "mamba" for mixer, _ in kinds)
    mlp = sum(cfg.dense_residual_ff > 0 if moe else cfg.d_ff > 0 for _, moe in kinds)
    return {"fused_conv3x3": 0, "flash_attention": attn, "fused_mlp": mlp * gen,
            "selective_scan": (len(kinds) - attn) * gen, "flash_attention_bwd": 0}


def zoo_control(rc):
    """A serve_zoo run's kernel-free reordering: the plain path with
    :func:`blocked_attention` for the attention and, for jamba's Mamba
    layers, the reference's chunk-recurrent scan (:func:`scan_control`)."""
    import dataclasses

    return dataclasses.replace(scan_control(rc), attention=blocked_attention)


def check_cache(cfg, cache: dict, length: int, what: str) -> None:
    """A decoder-only cache after ``what``: one entry per sublayer of the
    config's segments in their order, KV buffers for an attention sublayer
    and the conv inputs and state for a Mamba one, ``length`` positions."""
    from repro_torch.models import transformer as T

    kinds = [kind for spec in T.segments_of(cfg) for _ in range(spec.repeats)
             for kind in spec.kinds]
    held = [set(sub) for seg in cache["segments"] for layer in seg
            for sub in layer.values()]
    want = [{"conv", "h"} if mixer == "mamba" else {"k", "v"} for mixer, _ in kinds]
    check(held == want, f"{cfg.name}'s cache after {what} holds {held}, not {want} "
          "(the order of the config's sublayers)")
    check(cache["len"] == length,
          f"{cfg.name}'s cache after {what} holds {cache['len']} positions, not {length}")


def zoo_time(torch, run: dict, seed: int) -> dict:
    """One serve_zoo run's comparison with the plain path, its own weights
    (seeded ``seed + 8``) and prompts: the bfloat16 prefill logits through
    ``ops.KERNELS`` against ``ops.PLAIN`` within PREFILL_TOL, or
    CONTROL_FACTOR x what :func:`zoo_control` moves them by; an MoE run
    counts the routes the two paths choose apart, then runs the plain path
    and its reordering on the kernel path's routes
    (:func:`replayed_routes`); the hybrid cache's layout; the prefills of
    ZOO_ORDER (CUDA events, the median) and one decode of ``gen - 1``
    steps a path; then the float32 logits at ``run["f32_layers"]`` layers
    within PREFILL_TOL's float32 1e-3 x the largest."""
    import dataclasses

    from repro_torch.configs import resolve
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    full_depth = resolve(run["arch"]).n_layers
    cfg = serve_config(run)
    rc = serve_rc(cfg, run)
    B, S, n_gen = run["requests"], run["prompt_len"], run["gen"]
    max_seq = serve.cache_entries(cfg, S, n_gen)
    prompt = S + (cfg.frontend_len if cfg.frontend else 0)
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    params = M.init_params(cfg, generator=gen)
    batch = serve_batch(torch, cfg, B, S, gen)
    paths = {"kernels": ops.KERNELS, "plain": ops.PLAIN, "control": zoo_control(rc)}
    phase = f"serve_zoo {cfg.name}"
    out = {"logits": {}}

    def prefill(p, c, name):
        cache = M.init_cache(c, B, max_seq)
        return M.prefill(p, c, rc, batch, cache, kernels=paths[name])

    def logits_of(name):
        return prefill(params, cfg, name)[0]

    with torch.inference_mode():
        depth = depth_of(cfg, full_depth)
        if cfg.n_experts:  # the plain runs take the kernel run's expert choices
            kernels, routes = recorded_routes(lambda: logits_of("kernels"))
            free, free_routes = recorded_routes(lambda: logits_of("plain"))
            flips, n_routes = count_flips(routes, free_routes)
            free_err = float((kernels - free).abs().max())
            plain = replayed_routes(routes, lambda: logits_of("plain"))
            control = replayed_routes(routes, lambda: logits_of("control"))
            print(f"phase {phase}: bfloat16 prefill, kernels vs plain: {sum(flips)} of "
                  f"{n_routes} token routes ({len(flips)} MoE layers) chose another "
                  f"top-{cfg.top_k} expert set (by layer {flips}); the logits with "
                  f"each path's own routes differ by up to {free_err:.6g} (a flipped "
                  "route moves a token by whole experts), the plain path and its "
                  "reordering below take the kernel path's routes")
            del free
            depth += ", the kernel path's expert choices replayed"
        else:
            kernels, plain = logits_of("kernels"), logits_of("plain")
            control = logits_of("control")
        out["logits"]["bfloat16"] = _logits_agree(
            torch, "bfloat16", kernels, plain, PREFILL_TOL, phase, depth,
            control=float((control - plain).abs().max()))
        if cfg.n_experts:
            out["logits"]["bfloat16"]["routes_flipped"] = {
                "per_layer": flips, "routes": n_routes, "own_routes_max_abs_err": free_err}
        del kernels, plain, control
        samples = {f"{name}_{what}": [] for name in ("kernels", "plain")
                   for what in ("prefill", "decode")}
        for name in ZOO_ORDER:
            ms, (logits, cache) = event_ms(torch, lambda: prefill(params, cfg, name))
            samples[f"{name}_prefill"].append(ms)
            if not samples[f"{name}_decode"]:  # each path's first prefill decodes
                check_cache(cfg, cache, prompt, f"the prefill through the {name}")
                tok = logits[:, -1].argmax(-1)[:, None]

                def decode_all(tok=tok, cache=cache, name=name):
                    for _ in range(n_gen - 1):
                        lg, cache = M.decode(params, cfg, rc, tok, cache,
                                             kernels=paths[name])
                        tok = lg[:, -1].argmax(-1)[:, None]
                    return cache

                ms, cache = event_ms(torch, decode_all)
                samples[f"{name}_decode"].append(ms / (n_gen - 1))
                check_cache(cfg, cache, prompt + n_gen - 1,
                            f"{n_gen - 1} decode steps through the {name}")
            del logits, cache
        for name in ("kernels", "plain"):
            pre = statistics.median(samples[f"{name}_prefill"])
            dec = samples[f"{name}_decode"][0]
            out[name] = {"prefill_ms": pre, "prefill_samples": samples[f"{name}_prefill"],
                         "decode_ms_per_token": dec, "decode_tokens_per_s": B / dec * 1e3,
                         "tokens_per_s": B * n_gen / (pre + (n_gen - 1) * dec) * 1e3}
            print(f"phase {phase}: through the {name:7s}: prefill {pre:.3f} ms (median "
                  f"of {len(samples[f'{name}_prefill'])}), decode {dec:.3f} ms/token over "
                  f"{n_gen - 1} steps ({out[name]['decode_tokens_per_s']:.6g} tokens/s), "
                  f"{out[name]['tokens_per_s']:.6g} tokens/s end to end ({B} requests x "
                  f"prompt {prompt} + {n_gen} tokens)")
        del params
        torch.cuda.empty_cache()
        if run["f32_layers"] is not None:
            cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=run["f32_layers"])
            gen = torch.Generator(device="cuda").manual_seed(seed + 9)
            params32 = M.init_params(cfg32, generator=gen)
            batch = serve_batch(torch, cfg32, B, S, gen)
            lk = prefill(params32, cfg32, "kernels")[0]
            lp = prefill(params32, cfg32, "plain")[0]
            out["logits"]["float32"] = _logits_agree(
                torch, "float32", lk, lp, PREFILL_TOL, phase, depth_of(cfg32, full_depth))
            del params32, lk, lp
            torch.cuda.empty_cache()
    return out


def phase_serve_zoo(torch, np, seed: int) -> list:
    """The fifteenth main path: each SERVE_ZOO run through the serve entry
    point (``serve.main``, with ``--layers`` where the run cuts the depth),
    its launch counts zeroed just before and read just after, each equal to
    :func:`zoo_launches`; then :func:`zoo_time`; the peak device memory of
    the serve and of the whole run, and the run's seconds.  Every run's
    weights are freed before the next run's are made."""
    out = []
    for run in SERVE_ZOO:
        t0 = time.perf_counter()
        cfg = serve_config(run)
        want = zoo_launches(cfg, run["gen"])
        kinds = cfg.sublayer_kinds(0, cfg.n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        served = phase_serve(np, run, seed, "serve_zoo")
        counts = read_counts()
        serve_peak = torch.cuda.max_memory_allocated()
        check(counts == want,
              f"serving {cfg.name} ({depth_of(cfg)}: {kinds}) launched {counts}, not "
              f"{want}: flash_attention once per attention sublayer of the prefill, "
              f"fused_mlp once per dense MLP per forward, selective_scan once per "
              f"Mamba sublayer per forward, {run['gen']} forwards")
        print(f"phase main_path serve_zoo {cfg.name}: launches {counts}")
        torch.cuda.empty_cache()
        timed = zoo_time(torch, run, seed)
        peak = torch.cuda.max_memory_allocated()
        seconds = time.perf_counter() - t0
        print(f"phase serve_zoo {cfg.name}: peak device memory {serve_peak / 2**30:.3f} "
              f"GiB in the serve, {peak / 2**30:.3f} GiB in the run; {seconds:.1f} s")
        out.append({"arch": run["arch"], "name": cfg.name, "n_layers": cfg.n_layers,
                    "gen": run["gen"], "counts": counts, "serve": served,
                    "peak_serve_bytes": serve_peak, "peak_bytes": peak,
                    "seconds": seconds, **timed})
        torch.cuda.empty_cache()
    return out


def device_intervals(torch, prof) -> list:
    """[(start us, end us, name), ...] of every device activity a profile
    recorded, read from the profiler's raw events
    (``prof.profiler.kineto_results``, not a public interface: the public
    ``prof.events()`` builds a per-op event list, which took 8-15 s of the
    host's time for one training step).  tests/test_torch_on_card.py holds
    it to ``prof.events()``'s device events on a small step."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def busy_us(intervals: list) -> float:
    """Microseconds covered by the union of ``intervals`` ((start, end,
    ...) in microseconds)."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _device_busy(torch, fn, watch: tuple = ()) -> dict:
    """Host wall ms of ``fn()`` (synchronised), the ms the device was busy
    in it (the union of its kernel, copy and set intervals, from the
    profiler, which records the device's activity only:
    :func:`device_intervals`), the largest device times by name and the
    device times of the names that contain one of ``watch``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = device_intervals(torch, prof)
    busy = busy_us(device)
    by_name = {}
    for a, b, name in device:
        by_name[name[:50]] = by_name.get(name[:50], 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall if device else None,
            "kernels_launched": len(device), "top_device_ms": top,
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

    from repro_torch.core import roofline as RL
    from repro_torch.kernels import fused_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    serve_shape = (SERVE["requests"], SERVE["prompt_len"], SERVE["prompt_len"],
                   16, 8, 128)
    cases = [  # (label, (B, Sq, Skv, H, KV, hd), dtype, causal, window, chunk, tile)
        ("serve", serve_shape, "bfloat16", True, 0, 0, None),
        ("serve", serve_shape, "float32", True, 0, 0, None),
        ("serve_plan_tile", serve_shape, "bfloat16", True, 0, 0, plan_tile),
    ]
    cases += [(label, shape, "bfloat16", causal, window, chunk, None)
              for label, shape, causal, window, chunk in SERVE_ATTENTION]
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
        bq, bk = tile if tile else fused_attention.default_tile(hd, dtype, Skv)
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
            return plain_attention(q, k, v, **mask)

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
        kc = RL.kernel_cost("flash_attention", q=tuple(q.shape), kv=tuple(k.shape),
                            itemsize=es, **mask)
        n_bytes, flops = kc.bytes, kc.flops
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
        ATT_TOL["bfloat16"], RL.kernel_cost("flash_attention", q=tuple(q.shape),
                                            kv=tuple(k.shape), itemsize=2).flops)
    # qwen3's training shape, with the logsumexp the training forward writes
    B, S, H, KV, hd = TRAIN_RUN["batch"] // TRAIN_RUN["microbatches"], TRAIN_RUN["seq"], 16, 8, 128
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    rows += tile_sweep(
        torch, "attention train bfloat16 lse",
        lambda t: fused_attention.flash_attention_lse(q, k, v, block_q=t[0], block_k=t[1])[0],
        ref.flash_attention_ref(q, k, v).float(), fused_attention.TILES,
        ATT_TOL["bfloat16"], RL.kernel_cost("flash_attention", q=tuple(q.shape),
                                            kv=tuple(k.shape), itemsize=2, lse=True).flops)
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def phase_mlp(torch, spec, seed: int, plan_tile) -> list:
    """fused_mlp vs its plain version; yardstick: the same three matrix
    products and activation as separate cuBLAS / PyTorch calls in the
    input's dtype."""
    import torch.nn.functional as F

    from repro_torch.core import roofline as RL
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
        kc = RL.kernel_cost("fused_mlp", x=(T, d), ff=ff, gated=gated, itemsize=es)
        n_bytes, flops = kc.bytes, kc.flops
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
            MLP_TOL["bfloat16"],
            RL.kernel_cost("fused_mlp", x=(T, d), ff=ff, gated=True, itemsize=2).flops)
    return rows


SCAN_LIBRARY = "none: no single PyTorch call computes a selective scan"


def phase_scan(torch, spec, seed: int) -> list:
    """selective_scan vs its plain version at the serve shapes (with the
    initial state in and the final state out, as serving calls it), the
    shapes of tests/test_kernels.py (neither: the TPU kernel's function)
    and ragged ones.  No PyTorch call computes the same function, so there
    is no library time."""
    from repro_torch.configs import resolve
    from repro_torch.core import roofline as RL
    from repro_torch.kernels import mamba_scan, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    cfg = resolve(SERVE_SSM["arch"])
    B, S, di, ds = SERVE_SSM["requests"], SERVE_SSM["prompt_len"], cfg.d_inner, cfg.ssm_state
    zoo = serve_config(next(r for r in SERVE_ZOO if r["arch"] == "jamba"))
    cases = [  # (label, (B, S, di, ds), (chunk, block_d) or None, with state)
        ("serve_prefill", (B, S, di, ds), None, True),
        ("serve_decode", (B, 1, di, ds), None, True),
        # jamba's Mamba layers (phase serve_zoo): d_inner 16,384, twice
        # falcon-mamba's, so twice the channel blocks
        ("jamba_prefill", (B, S, zoo.d_inner, zoo.ssm_state), None, True),
        ("jamba_decode", (B, 1, zoo.d_inner, zoo.ssm_state), None, True),
        ("test_kernels", (1, 64, 16, 4), (16, 16), False),
        ("test_kernels", (2, 128, 32, 8), (32, 16), False),
        ("test_kernels", (1, 64, 64, 16), (64, 32), False),
        ("ragged", (3, 200, 1000, 16), (64, 384), True),
        ("ragged", (2, 77, 300, 5), None, True),
    ]
    cases += [(label, shape, None, True) for label, shape in SERVE_SCAN]
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
        device_ms = graph_ms(torch, kernel) if label.endswith("_decode") else None
        kc = RL.kernel_cost("selective_scan", x=(b, s, di, ds), h0=state, final_state=state)
        n_bytes, flops = kc.bytes, kc.flops
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
    """Model FLOPs of a training step by this script's own definition, the
    second of two (phase roofline prints both): 6 N D (N every parameter,
    the tied head's product included) plus the attention's products, 4 per
    visible pair and head dim forward and 8 backward, at ``batch``
    sequences of ``seq``; the remat recompute is not counted.  The
    reference's ``roofline.model_flops`` counts 6 N_active D and no
    attention."""
    from repro_torch.core import roofline as RL

    n = cfg.param_counts()["total"]
    pairs = RL.visible_pairs(seq, seq, True, 0, 0)
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
    """TRAIN_TIMED_STEPS more steps from the trained state through the
    donated step ``launch.train.run`` takes (``make_train_step(...,
    donate=True)``), each timed on the host's clock up to a synchronise: ms
    per step, tokens/s, model TFLOP/s; then one profiled step's device idle
    share."""
    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.runtime.steps import make_train_step

    cfg = resolve(TRAIN_RUN["arch"])
    step = make_train_step(cfg, train_rc(cfg), donate=True)
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


# Phase roofline: the dry run's cells (both production meshes each), run on
# the host in one subprocess a cell, and the steps whose rooflines are held
# against this run's measured times.
DRYRUN_CELLS = [("qwen3", "train_4k"), ("qwen3", "decode_32k")]


def phase_roofline(torch, card: str, train_time: dict, serve_time: dict) -> dict:
    """The cost tools on this run's steps: (a) ``launch.dryrun`` of
    DRYRUN_CELLS on the 16x16 and 2x16x16 meshes, on the host; (b) the
    roofline of phase train's step and of phase serve's prefill, each
    walked at its shapes (``dryrun.one_device_roofline``) against the
    H100's data-sheet peaks, beside the measured medians: the
    reference-definition MFU (6 N_active D, ``roofline.model_flops``) of the
    measured step, train_time's other definition beside it, and the share
    bound / measured, which fails the run above 1.0 (a step faster than
    its bound).  (c), the kernel rows' bytes and FLOPs from
    ``roofline.kernel_cost``, is in the kernel phases.  No kernel runs."""
    from repro_torch.configs import ShapeConfig, resolve
    from repro_torch.core.arch import H100
    from repro_torch.launch import dryrun as D

    before = read_counts()
    t0 = time.perf_counter()
    out_dir = REPORT.parent / "dryrun"
    failures = D.sweep(DRYRUN_CELLS, ("single", "multi"), out_dir, jobs=4, force=True)
    check(not failures, f"phase roofline: the dry run failed for {failures}")
    out = {"dryrun": [], "dryrun_seconds": time.perf_counter() - t0}
    for arch, shape in DRYRUN_CELLS:
        for mesh in ("single", "multi"):
            r = json.loads((out_dir / f"{resolve(arch).name}__{shape}__{mesh}.json")
                           .read_text())
            rl, mem = r["roofline"], r["memory_analysis"]
            step_ms = max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) * 1e3
            out["dryrun"].append({"arch": r["arch"], "shape": shape, "mesh": mesh,
                                  "n_chips": r["n_chips"], "step_ms": step_ms,
                                  "resident_total_gib": r["resident_total_gib"],
                                  "roofline": rl, "memory_analysis": mem,
                                  "seconds": r["seconds"]})
            print(f"phase roofline: dry run {r['arch']} {shape} {mesh} ({r['n_chips']} "
                  f"devices, traced on the host in {r['seconds']['trace']:.1f} s): resident "
                  f"{r['resident_total_gib']:.4f} GiB/device, bound {rl['bound']}, step >= "
                  f"{step_ms:.4f} ms, mfu <= {rl['mfu_bound'] * 100:.4f} %, useful FLOPs "
                  f"{rl['useful_flops_ratio']:.4f}, peak live {mem['peak_live_bytes'] / 2**30:.3f}"
                  f" GiB/device (H100 data-sheet peaks; card here {card})")

    def held(name, cfg, shape, rc, measured_ms, cache_len=None):
        t = time.perf_counter()
        rl, walked = D.one_device_roofline(cfg, shape, rc, cache_len=cache_len)
        share = rl.step_seconds * 1e3 / measured_ms
        glue_ms = (rl.hbm_bytes_upper - rl.hbm_bytes) / H100.hbm_bw * 1e3
        row = {"roofline": rl.row(), "step_ms": rl.step_seconds * 1e3,
               "measured_ms": measured_ms, "share": share,
               "mfu_measured": rl.mfu(measured_ms / 1e3), "glue_bound_ms": glue_ms,
               "memory_analysis": walked["live"], "depths": walked["depths"],
               "seconds": time.perf_counter() - t}
        print(f"phase roofline: {name} ({cfg.name}, {shape.global_batch} x {shape.seq_len}, "
              f"walked at depths {walked['depths']} of {cfg.n_layers} in {row['seconds']:.1f}"
              f" s): {rl.flops:.6g} FLOPs ({rl.coll_breakdown['dot_flops']:.6g} in "
              f"products), {rl.hbm_bytes:.6g} bytes fused ({rl.hbm_bytes_upper:.6g} by "
              f"Eq. (1) groups); compute {rl.compute_s * 1e3:.4f} ms, memory "
              f"{rl.memory_s * 1e3:.4f} ms (groups {rl.memory_s_upper * 1e3:.4f}), "
              f"collective {rl.collective_s * 1e3:.4f} ms: bound {rl.bound}, step >= "
              f"{row['step_ms']:.4f} ms; measured {measured_ms:.3f} ms, share {share:.4f}; "
              f"MFU of the measured step {row['mfu_measured'] * 100:.4f} % "
              f"(roofline.model_flops, {rl.model_flops_per_device:.6g} FLOPs: "
              f"{'6' if shape.kind == 'train' else '2'} N_active D, over 989 TFLOP/s), "
              f"useful FLOPs "
              f"{rl.useful_flops_ratio:.4f}; the elementwise groups' bytes beyond the "
              f"fused count {glue_ms:.3f} ms at 3.35 TB/s [{card}]")
        check(share <= 1.0, f"phase roofline: the {name} took {measured_ms:.3f} ms, less "
              f"than its roofline bound {row['step_ms']:.3f} ms")
        return row

    cfg = resolve(TRAIN_RUN["arch"])
    out["train"] = held("train step", cfg, ShapeConfig("train_run", TRAIN_RUN["seq"],
                                                       TRAIN_RUN["batch"], "train"),
                        train_rc(cfg), train_time["median_step_ms"])
    other = train_time["tflops"] * 1e12 / H100.peak_flops
    out["train"]["mfu_other_definition"] = other
    print(f"phase roofline: the train step's model FLOP/s by the other definition "
          f"(train_model_flops: 6 N_total D + attention, {train_time['model_flops']:.6g} "
          f"a step): {train_time['tflops']:.6g} TFLOP/s, {other * 100:.4f} % of 989 "
          f"TFLOP/s, against {out['train']['mfu_measured'] * 100:.4f} % by "
          f"roofline.model_flops [{card}]")
    scfg = serve_config(SERVE)
    out["prefill"] = held("serve prefill", scfg,
                          ShapeConfig("serve_prefill", SERVE["prompt_len"], SERVE["requests"],
                                      "prefill"),
                          serve_rc(scfg, SERVE), serve_time["kernels"]["prefill_ms"],
                          cache_len=SERVE["prompt_len"] + SERVE["gen"] + 8)
    check(read_counts() == before, "phase roofline launched a kernel")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase roofline: {out['seconds']:.1f} s (the dry run {out['dryrun_seconds']:.1f})")
    return out


def _loss_and_grads(torch, cfg, rc, params, batch, kernels):
    """(loss, the gradient of every parameter leaf in its own dtype)."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import model as M

    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc, batch, kernels=kernels)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), list(grads)


def _rel_l2(torch, got: list, want: list) -> list:
    """Relative L2 of each leaf, in float32 at least (a leaf at a time)."""
    out = []
    for a, b in zip(got, want):
        dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
        a, b = a.to(dt), b.to(dt)
        out.append(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)))
    return out


def grad_parity(torch, cfg, rc, dname: str, params, batch, phase: str, what: str) -> dict:
    """One microbatch's loss and gradients through the training path (K2
    and its backward, the main path's flash_vjp route, and the chunked,
    checkpointed scan) against the plain path (``ref.flash_attention_ref``
    and the sequential ``ref.selective_scan_ref`` under autograd), and in
    bfloat16 also a kernel-free reordering against the plain path
    (:func:`blocked_attention`, and the chunked scan at half the run's
    chunk): every leaf's relative L2 within TRAIN_PARITY_TOL[dname], or in
    bfloat16 CONTROL_FACTOR x the reordering's if larger; the losses within
    TRAIN_PARITY_TOL[dname] relative.  An MoE model's plain path and
    control take the kernel path's expert choices (:func:`replayed_routes`,
    the backward's recompute included), and the routes the plain path's own
    forward chooses apart are counted."""
    import dataclasses
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM

    train = ops.train_kernels(rc.mamba_chunk)
    plain_rc = dataclasses.replace(rc, flash_vjp=False)
    plain = dataclasses.replace(train, attention=ref.flash_attention_ref,
                                ssm_scan=ref.selective_scan_ref)
    control = dataclasses.replace(
        plain, attention=blocked_attention,
        ssm_scan=functools.partial(SSM.selective_scan_chunked, chunk=max(rc.mamba_chunk // 2, 1)))
    paths = {"kernels": (rc, train), "plain": (plain_rc, plain),
             "control": (plain_rc, control)}

    def grads_of(name, routes=None):
        c, k = paths[name]
        if routes is None:
            return _loss_and_grads(torch, cfg, c, params, batch, k)
        return replayed_routes(routes, lambda: _loss_and_grads(torch, cfg, c, params, batch, k))

    out = {"flips": None}
    routes = None
    if cfg.n_experts:
        (lk, gk), routes = recorded_routes(lambda: grads_of("kernels"))
        c, k = paths["plain"]
        with torch.no_grad():  # the plain path's own routes: its forward
            _, own = recorded_routes(lambda: M.loss_fn(params, cfg, c, batch, kernels=k))
        flips, n_routes = count_flips(routes[:len(own)], own)
        out["flips"] = {"per_layer": flips, "routes": n_routes}
    else:
        lk, gk = grads_of("kernels")
    lp, gp = grads_of("plain", routes)
    rel = _rel_l2(torch, gk, gp)
    del gk
    tol = TRAIN_PARITY_TOL[dname]
    control = None
    allowed = [tol] * len(rel)
    if dname == "bfloat16":
        _, gc = grads_of("control", routes)
        control = _rel_l2(torch, gc, gp)
        del gc
        allowed = [max(tol, CONTROL_FACTOR * c) for c in control]
    del gp
    names = [pytree.keystr(path) for path, _ in pytree.tree_flatten_with_path(params)[0]]
    order = sorted(range(len(rel)), key=lambda i: rel[i] / allowed[i], reverse=True)
    worst = order[0]
    nearest = "; ".join(
        f"{names[i]} {rel[i]:.4g}" + ("" if control is None else f" (reordering {control[i]:.4g})")
        for i in order[:3])
    check(all(r <= a for r, a in zip(rel, allowed)),
          f"{phase} {dname}: gradient leaf {worst} {names[worst]} differs from plain by "
          f"relative L2 {rel[worst]:.4g} > {allowed[worst]:.4g}; nearest their limits: "
          f"{nearest}")
    check(abs(lk - lp) <= tol * abs(lp),
          f"{phase} {dname}: loss {lk!r} through the kernels, {lp!r} plain")
    rule = f"{tol}" if control is None else (
        f"{tol} or {CONTROL_FACTOR} x the reordering's; the reordering vs plain: "
        f"median {statistics.median(control):.4g}, max {max(control):.4g}")
    flipped = "" if routes is None else (
        f"; {sum(out['flips']['per_layer'])} of {out['flips']['routes']} token routes of "
        f"the forward chose another top-{cfg.top_k} expert set in the plain path (by "
        f"layer {out['flips']['per_layer']}), its gradients above with the kernel "
        "path's routes replayed")
    print(f"phase {phase}: {dname} at {what}: loss {lk!r} through the kernels, {lp!r} "
          f"plain; gradients' relative L2 per leaf over {len(rel)} leaves, kernels vs "
          f"plain: median {statistics.median(rel):.4g}, max {max(rel):.4g} (leaf {worst}, "
          f"allowed {allowed[worst]:.4g}: {rule}); nearest their limits: {nearest}{flipped}")
    out.update({"loss_kernels": lk, "loss_plain": lp, "rel_l2": rel,
                "control_rel_l2": control, "allowed": allowed,
                "leaves": names, "depth": what})
    return out


def phase_train_parity(torch, seed: int) -> dict:
    """:func:`grad_parity` of qwen3-0.6b's training microbatch: bfloat16 at
    full depth and float32 at TRAIN_F32_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import batch_to_device

    out = {}
    full = resolve(TRAIN_RUN["arch"])
    B = TRAIN_RUN["batch"] // TRAIN_RUN["microbatches"]
    for dname, cfg in (("bfloat16", full),
                       ("float32", dataclasses.replace(full, n_layers=TRAIN_F32_LAYERS,
                                                       dtype="float32"))):
        params = M.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(
            seed + 12), device="cuda")
        batch = batch_to_device(make_batch(cfg, B, TRAIN_RUN["seq"], seed=seed, step=300),
                                "cuda")
        out[dname] = grad_parity(
            torch, cfg, train_rc(cfg), dname, params, batch, "train_parity",
            f"{depth_of(cfg, full.n_layers)}, one microbatch of {B} x {TRAIN_RUN['seq']}")
        del params, batch
        torch.cuda.empty_cache()
    return out


# The sixteenth main path, phase train_zoo: seven more registry families
# trained at full width through launch.train.run on one card, train_4k's
# run config (its microbatches; "full" remat and the custom-VJP flash
# attention, as phase train) and 4096 tokens a sequence: "batch" sequences
# a step (two, four where train_4k takes four microbatches), TRAIN_ZOO_STEPS
# steps.  "n_layers": the depth where the card's 80 GB cut it (the layers
# kept hold every sublayer kind of the model).  The training state is 16
# bytes a parameter (bfloat16 parameter, float32 m and v, float32 gradient
# sums and a microbatch's bfloat16 gradient; 12 with one microbatch, no
# sums) by ``cfg.param_counts()``: internvl2-1b 0.494 B (4096 tokens after
# its 256 vision frames, labels -1 over the frames), seamless 1.370 B (24 +
# 24 layers, 1024 encoder frames: cross attention 4096 x 1024), phi3-mini
# 3.723 B (hd 96), gemma3-27b's superblock 3.887 B (5 sliding-window layers
# of 1024 and the global one; 62.2 GB), granite-34b 8 of 88 layers 3.335 B
# (MQA 48/1), mixtral 2 of 32 layers 3.034 B (8 experts, top-2), falcon-mamba
# 24 of 64 layers 2.794 B (no attention: the chunked scan's backward).
# "f32": the float32 parity's depth (default TRAIN_F32_LAYERS layers): a
# depth holding every sublayer kind, gemma3's global layer and seamless's
# cross attention included.  "bf16": the bfloat16 parity's depth where it
# is not the run's.  falcon-mamba's plain path runs the sequential scan
# (ref.selective_scan_ref: 4096 steps of a few small ops a layer, forward,
# recompute and backward under autograd, ~25 s a layer on an H100), so both
# its parities take 1 of its 24 layers (its one sublayer kind), to keep the
# phase in its time.  llama4, arctic and jamba are not trained: one
# MoE layer's experts (16.1, 13.4, 9.7 B parameters) take 97-161 GB of
# training state.
TRAIN_ZOO = [
    {"arch": "internvl2", "batch": 2},
    {"arch": "seamless", "batch": 2, "f32": {"n_layers": 2, "n_enc_layers": 2}},
    {"arch": "phi3", "batch": 2},
    {"arch": "gemma3", "batch": 4, "n_layers": 6, "f32": {"n_layers": 6}},
    {"arch": "granite", "batch": 4, "n_layers": 8},
    {"arch": "mixtral", "batch": 2, "n_layers": 2},
    {"arch": "falcon-mamba", "batch": 2, "n_layers": 24, "bf16": {"n_layers": 1},
     "f32": {"n_layers": 1}},
]
TRAIN_ZOO_STEPS = 3
TRAIN_ZOO_SEQ = 4096


def train_zoo_rc(cfg):
    """A train_zoo run's configuration: train_4k's run config with its own
    microbatches, "full" remat, the custom-VJP flash attention and
    launch.train's warmup."""
    from repro_torch.configs import run_config

    return run_config(cfg.name, "train_4k", remat="full", flash_vjp=True,
                      warmup_steps=max(TRAIN_ZOO_STEPS // 10, 1))


def train_state_bytes(cfg, microbatches: int) -> float:
    """The training state a donated step holds, by ``cfg.param_counts()``:
    a bfloat16 parameter (2 bytes), float32 m and v (8), a microbatch's
    bfloat16 gradient (2) and, with several microbatches, the float32
    gradient sums (4)."""
    return cfg.param_counts()["total"] * (2 + 8 + 2 + (4 if microbatches > 1 else 0))


def train_launches(cfg, steps: int, microbatches: int) -> dict:
    """The launches ``steps`` training steps of ``cfg`` in ``microbatches``
    microbatches make under "full" remat: flash_attention twice per
    attention sublayer per microbatch (the forward and the backward's
    recompute; seamless's encoder, decoder and cross attention each count)
    and flash_attention_bwd once; no other kernel (the MLP and the scan
    train through torch ops)."""
    if cfg.is_encoder_decoder:
        attn = cfg.n_enc_layers + 2 * cfg.n_layers
    else:
        attn = sum(mixer != "mamba" for mixer, _ in cfg.sublayer_kinds(0, cfg.n_layers))
    n = attn * microbatches * steps
    return {"fused_conv3x3": 0, "flash_attention": 2 * n, "fused_mlp": 0,
            "selective_scan": 0, "flash_attention_bwd": n}


def train_zoo_shapes(run: dict) -> list:
    """The attention launches of one microbatch of a train_zoo run, by
    shape: [(label, (B, Sq, Skv, H, KV, hd), causal, window, chunk,
    sublayers), ...], the labels of its TRAIN_KERNEL_CASES rows (a model
    with sliding-window and global layers has a row of each)."""
    cfg = serve_config(run)
    B, S = run["batch"] // train_zoo_rc(cfg).microbatches, TRAIN_ZOO_SEQ
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    arch = run["arch"]
    if cfg.is_encoder_decoder:
        F = cfg.frontend_len
        return [(f"{arch}_encoder_train", (B, F, F, *heads), False, 0, 0, cfg.n_enc_layers),
                (f"{arch}_decoder_train", (B, S, S, *heads), True, 0, 0, cfg.n_layers),
                (f"{arch}_cross_train", (B, S, F, *heads), False, 0, 0, cfg.n_layers)]
    S += cfg.frontend_len if cfg.frontend else 0
    mixed = len(set(cfg.layer_pattern) - {"mamba"}) > 1
    rows = {}
    for mixer, _ in cfg.sublayer_kinds(0, cfg.n_layers):
        if mixer == "mamba":
            continue
        window = cfg.window_size if mixer == "attn_local" else 0
        chunk = cfg.chunk_size if mixer == "attn_chunked" else 0
        label = f"{arch}_{'local' if window else 'global'}_train" if mixed else f"{arch}_train"
        rows.setdefault(label, [label, (B, S, S, *heads), True, window, chunk, 0])[5] += 1
    return [tuple(r) for r in rows.values()]


def _timed_train_steps(times: list):
    """A stand-in for ``launch.train.make_train_step`` whose steps append
    their host ms (synchronised before and after) to ``times``."""
    import torch

    from repro_torch.launch import train

    real = train.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    return make


def phase_train_zoo(torch, seed: int, tmp: Path) -> list:
    """The sixteenth main path: each TRAIN_ZOO run through
    ``launch.train.run`` on the card (TRAIN_ZOO_STEPS steps, seeded
    weights, the trainer's data), its launch counts zeroed just before and
    read just after, each equal to :func:`train_launches`; every loss
    finite; ms a step (the mean of the warm steps, host clock up to a
    synchronise), tokens/s, the peak device memory; then
    :func:`grad_parity` of one microbatch in bfloat16 at the run's depth
    (or its "bf16" one) and in float32 at its "f32" depth.  Every run's state is freed before
    the next run's is made."""
    import dataclasses
    import math

    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import batch_to_device

    out = []
    for run in TRAIN_ZOO:
        t0 = time.perf_counter()
        cfg = serve_config(run)
        rc = train_zoo_rc(cfg)
        full_depth = resolve(run["arch"]).n_layers
        want = train_launches(cfg, TRAIN_ZOO_STEPS, rc.microbatches)
        times = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        real = train.make_train_step
        train.make_train_step = _timed_train_steps(times)
        try:
            zero_counts()
            trained = train.run(cfg, rc, steps=TRAIN_ZOO_STEPS, batch=run["batch"],
                                seq=TRAIN_ZOO_SEQ, ckpt_dir=tmp / run["arch"],
                                ckpt_every=TRAIN_ZOO_STEPS + 1, seed=seed, device="cuda")
            counts = read_counts()
        finally:
            train.make_train_step = real
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        losses = trained["report"].losses
        n_params = trained["n_params"]
        del trained
        torch.cuda.empty_cache()
        check(counts == want,
              f"training {cfg.name} ({depth_of(cfg)}) launched {counts}, not {want}: "
              f"flash_attention twice (the forward and its recompute) and "
              f"flash_attention_bwd once per attention sublayer per microbatch, "
              f"{rc.microbatches} microbatches x {TRAIN_ZOO_STEPS} steps")
        print(f"phase main_path train_zoo {cfg.name}: launches {counts}")
        check(len(losses) == TRAIN_ZOO_STEPS and all(math.isfinite(x) for x in losses),
              f"training {cfg.name}: losses {losses}")
        tokens = run["batch"] * TRAIN_ZOO_SEQ
        state = train_state_bytes(cfg, rc.microbatches)
        warm = times[1:]
        ms = statistics.mean(warm)
        frames = (f" after {cfg.frontend_len} {cfg.frontend} frames" if cfg.frontend
                  else "")
        print(f"phase train_zoo {cfg.name}: {depth_of(cfg, full_depth)}, bfloat16, "
              f"{n_params:,} parameters; {TRAIN_ZOO_STEPS} steps of {run['batch']} x "
              f"{TRAIN_ZOO_SEQ} tokens{frames} ({rc.microbatches} microbatches, remat "
              f"{rc.remat}, flash_vjp): losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; {', '.join(f'{t:.3f}' for t in times)} ms a step, {ms:.3f} over the "
              f"{len(warm)} warm ones, {tokens / ms * 1e3:.6g} tokens/s; peak device "
              f"memory {peak / 2**30:.3f} GiB (the state reckoned {state / 2**30:.3f})")
        row = {"arch": run["arch"], "name": cfg.name, "n_layers": cfg.n_layers,
               "n_enc_layers": cfg.n_enc_layers, "batch": run["batch"],
               "microbatches": rc.microbatches, "n_params": n_params, "counts": counts,
               "losses": losses, "step_ms": times, "warm_step_ms": ms,
               "tokens_per_s": tokens / ms * 1e3, "peak_bytes": peak,
               "reckoned_state_bytes": state,
               "shapes": train_zoo_shapes(run)}
        f32 = run.get("f32", {"n_layers": TRAIN_F32_LAYERS})
        for dname, c in (("bfloat16", dataclasses.replace(cfg, **run.get("bf16", {}))),
                         ("float32", dataclasses.replace(cfg, dtype="float32", **f32))):
            B = run["batch"] // rc.microbatches
            seq = TRAIN_ZOO_SEQ + (c.frontend_len if c.frontend and not
                                   c.is_encoder_decoder else 0)
            gen = torch.Generator(device="cuda").manual_seed(seed + 14)
            params = M.init_params(c, generator=gen, device="cuda")
            batch = batch_to_device(make_batch(c, B, seq, seed=seed, step=300), "cuda")
            row[dname] = grad_parity(
                torch, c, train_zoo_rc(c), dname, params, batch, f"train_zoo {cfg.name}",
                f"{depth_of(c, full_depth)}, one microbatch of {B} x {seq}")
            del params, batch
            torch.cuda.empty_cache()
        row["peak_run_bytes"] = torch.cuda.max_memory_allocated()
        row["seconds"] = time.perf_counter() - t0
        print(f"phase train_zoo {cfg.name}: peak device memory {peak / 2**30:.3f} GiB in "
              f"the training, {row['peak_run_bytes'] / 2**30:.3f} GiB in the run; "
              f"{row['seconds']:.1f} s")
        out.append(row)
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
# 3 steps of each (the median of the 2 after the first; 5 until PR 28, cut
# to keep the script within its time with phase serve_zoo, ~12 s).
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
    # One more step of each from the final states, profiled (its results
    # dropped): the device's busy time, and the collective calls the
    # sharded step makes at one rank.
    trace1 = _device_busy(torch, lambda: single(p1, o1, batches[0]))
    with _CollectiveClock(dist) as clock:
        trace2 = _device_busy(torch, lambda: sharded(p2, o2, batches[0]))
    del p1, o1, p2, o2, leaves
    torch.cuda.empty_cache()
    ms_1, ms_2 = statistics.median(ms1[1:]), statistics.median(ms2[1:])
    print(f"phase train_sharded: {cfg.name} bfloat16, {n} steps of {TRAIN_RUN['batch']} x "
          f"{TRAIN_RUN['seq']} tokens on a {tuple(mesh.shape)} {mesh.mesh_dim_names} "
          f"nccl mesh of {world} rank against as many single-device steps from the same "
          f"state and batches: losses {loss2} "
          + ("bit-equal" if loss1 == loss2 else f"against {loss1}")
          + "; parameters / m / v bit-equal in "
          + ", ".join(f"{parity[w]['bit_equal']} / {parity[w]['leaves']}" for w in parity)
          + f" leaves; ms a step {', '.join(f'{t:.3f}' for t in ms2)} (median of the "
          f"warm steps after the first {ms_2:.3f}) sharded, "
          f"{', '.join(f'{t:.3f}' for t in ms1)} (median {ms_1:.3f}) single; peak "
          f"device memory {peak2 / 2**30:.3f} GiB sharded ({rise2 / 2**30:.3f} above its "
          f"start), {peak1 / 2**30:.3f} GiB single ({rise1 / 2**30:.3f} above its start)")
    print(f"phase train_sharded: a profiled step of each: single wall "
          f"{trace1['wall_ms']:.3f} ms, device busy {trace1['device_busy_ms']:.3f} ms (idle "
          f"share {trace1['device_idle_share']:.4f}); sharded wall {trace2['wall_ms']:.3f} "
          f"ms, device busy {trace2['device_busy_ms']:.3f} ms (idle share "
          f"{trace2['device_idle_share']:.4f}), {clock.calls} collective calls taking "
          f"{clock.ms:.3f} ms of the host's time")
    out.update({"losses_sharded": loss2, "losses_single": loss1, "ms_sharded": ms2,
                "ms_single": ms1, "peak_sharded": peak2, "peak_single": peak1,
                "rise_sharded": rise2, "rise_single": rise1, "parity": parity,
                "counts": counts, "trace_single": trace1, "trace_sharded": trace2,
                "collective_calls": clock.calls, "collective_host_ms": clock.ms})

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


# The partitioned training path (main path 13): qwen3-0.6b at full width
# and depth on a (1, 2) ("data", "model") mesh of two processes on the one
# card over gloo.  The batch is cut to 2 sequences of 2,048 tokens (one
# microbatch) a step: gloo carries a CUDA tensor's collectives through the
# host, and a layer makes six all-reduces of the (2, 2048, 1024) bfloat16
# activations a step (forward, remat recompute, backward), so the train_4k
# step of phase train would spend minutes in them.  TRAIN_TP's steps (the
# first warms up, the rest are timed warm), one more step under the
# profiler (the device's busy time and the host time spent in the
# collectives' calls), and TRAIN_TP's prefills of 8 x 512 prompt tokens
# (SERVE's; the first cold, the rest warm), against the single-device
# steps and prefills from the same state.
#
# What holds the partitioned backward: the first step's gradients.  Its
# learning rate is 0 (warmup_cosine at step 0), and Adam's first moment
# after it is 0.1 x the clipped gradient, so the moments m of the two
# paths after step 1 are compared per leaf by relative L2, at TP_GRAD_TOL.
# The parameters after the last step cannot show a gradient's fault: Adam
# moves each element by about lr whatever the gradient.  They are held to
# that ceiling (_adam_ceiling), which any gradients meet, as a check that
# the pieces are updated and gathered where they belong (a misplaced piece
# is off by |w|, some 50x the ceiling).  The losses (forward passes) are
# held at TRAIN_PARITY_TOL["bfloat16"], the prefill's logits at
# PREFILL_TOL["bfloat16"] x max |logit|.
TRAIN_TP = {"arch": "qwen3", "mesh": (1, 2), "batch": 2, "seq": 2048, "steps": 4,
            "prefills": 4, "timeout_s": 480}
# The first step's gradients, partitioned against single-device, relative
# L2 per leaf.  In bfloat16 the row-parallel products' partial sums are
# rounded and added in another order, and the differences grow over 28
# layers; the norm scales' gradients, sums over 4,096 tokens with
# cancellation, differ most: 0.0186 at most on the sound tree (NVIDIA H100
# 80GB HBM3, 700.00 W; median 0.0065 over 310 leaves), where float32 on the
# CPU agrees to 1e-6.  A planted fault, the q-norm scale used without
# enter_model (each rank's gradient its own heads' share), gives its 28
# leaves 0.355-0.858.  5e-2 sits 2.7x above the one and 7x below the other.
TP_GRAD_TOL = 5e-2
# The collectives the partitioned path makes, each checked on CUDA tensors
# over gloo before the path runs.
TP_COLLECTIVES = ("all_reduce", "all_reduce_max", "all_gather_into_tensor")


def phase_train_tp(torch, card: str, seed: int, tmp: Path) -> dict:
    """Main path 13: start the two ranks (this script with ``--tp-worker
    RANK DIR``), wait for them, and print what rank 0 checked and measured
    (it fails, and so does this phase, if a check does)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--seed",
                               str(seed), "--tp-worker", str(r), str(tmp)])
             for r in range(2)]
    deadline = time.monotonic() + TRAIN_TP["timeout_s"]
    try:  # a rank that fails leaves its peer waiting in a collective: stop both
        while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
               and not any(p.poll() for p in procs)):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"the train_tp ranks exited with {rcs} (killed: -9; after "
          f"at most {TRAIN_TP['timeout_s']} s)")
    ranks = [json.loads((tmp / f"tp_rank{r}.json").read_text()) for r in range(2)]
    out = dict(ranks[0])
    out["peak_per_rank"] = [r["peak"] for r in ranks]
    out["seconds"] = time.perf_counter() - t0
    n, cfg_layers = TRAIN_TP["steps"], out["layers"]
    g, tr = out["grad_rel_l2"], out["trace"]
    print(f"phase main_path train_tp: launches {out['train_counts']} ({n} steps x "
          f"{cfg_layers} layers at {out['local_heads']} of {out['heads']} heads); "
          f"prefill {out['prefill_counts']} ({TRAIN_TP['prefills']} prefills, fused_mlp "
          f"at {out['local_ff']} of {out['ff']} columns)")
    print(f"phase train_tp: {card}; qwen3-0.6b bfloat16 on a {TRAIN_TP['mesh']} "
          f"('data', 'model') mesh of 2 processes on one card over gloo (CUDA "
          f"collectives checked: {', '.join(k for k, v in out['probe'].items() if v)}); "
          f"{n} steps of {TRAIN_TP['batch']} x {TRAIN_TP['seq']} tokens")
    print(f"phase train_tp: first step's gradients (Adam's m after step 1), "
          f"partitioned vs single-device, relative L2 per leaf over {len(g)} leaves: "
          f"median {statistics.median(g):.4g}, max {max(g):.4g} ({out['grad_worst']}; "
          f"<= {TP_GRAD_TOL})")
    print(f"phase train_tp: losses " + ", ".join(f"{x:.6f}" for x in out["losses_tp"])
          + " against single-device " + ", ".join(f"{x:.6f}" for x in out["losses_single"])
          + f"; parameters after {n} steps: the largest difference per leaf "
          f"{out['param_share_of_ceiling']:.4g} of what AdamW can move them "
          f"({out['param_far']}; <= 1)")
    print(f"phase train_tp: ms a step, partitioned: first {out['ms_tp'][0]:.3f}, warm "
          + ", ".join(f"{t:.3f}" for t in out["ms_tp"][1:])
          + f" (median {statistics.median(out['ms_tp'][1:]):.3f}); single: first "
          f"{out['ms_single'][0]:.3f}, warm " + ", ".join(f"{t:.3f}" for t in
                                                       out["ms_single"][1:])
          + f" (median {statistics.median(out['ms_single'][1:]):.3f}); peak device "
          f"memory per rank {', '.join(f'{b / 2**30:.3f}' for b in out['peak_per_rank'])} "
          f"GiB (single {out['peak_single'] / 2**30:.3f} GiB)")
    print(f"phase train_tp: a profiled partitioned step (rank 0): wall "
          f"{tr['wall_ms']:.3f} ms, device busy {tr['device_busy_ms']:.3f} ms, idle share "
          f"{tr['device_idle_share']:.4f}; {tr['collective_calls']} collective calls "
          f"took {tr['collective_host_ms']:.3f} ms of the host's time "
          f"({tr['collective_host_ms'] / tr['wall_ms']:.4f} of the wall)")
    print(f"phase train_tp: prefill 8 x 512: logits max |diff| {out['prefill_max_abs']:.4g} "
          f"of max |logit| {out['prefill_max_logit']:.4g} (<= {PREFILL_TOL['bfloat16']} x); "
          f"ms partitioned: cold {out['prefill_ms'][0]:.3f}, warm "
          + ", ".join(f"{t:.3f}" for t in out["prefill_ms"][1:])
          + f"; single: cold {out['prefill_ms_single'][0]:.3f}, warm "
          + ", ".join(f"{t:.3f}" for t in out["prefill_ms_single"][1:])
          + f"; {out['seconds']:.1f} s")
    return out


def _probe_gloo(torch, dist, rank: int) -> dict:
    """Which of TP_COLLECTIVES gloo computes right on CUDA tensors (an
    exception counts as no)."""
    ok = {}
    x = torch.full((4,), float(rank + 1), device="cuda")
    for name in TP_COLLECTIVES:
        try:
            if name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok[name] = bool((y == 3.0).all())
            elif name == "all_reduce_max":
                y = x.clone()
                dist.all_reduce(y, op=dist.ReduceOp.MAX)
                ok[name] = bool((y == 2.0).all())
            else:
                buf = torch.empty(8, device="cuda")
                dist.all_gather_into_tensor(buf, x)
                ok[name] = bool(torch.equal(buf.cpu(), torch.tensor([1.0] * 4 + [2.0] * 4)))
        except Exception as e:  # noqa: BLE001 - reported, then the phase fails
            print(f"train_tp rank {rank}: gloo {name} on CUDA tensors raised {e!r}",
                  flush=True)
            ok[name] = False
    return ok


class _CollectiveClock:
    """While entered, every call of ``torch.distributed``'s all-reduce and
    all-gathers (the collectives of the partitioned step at one data rank)
    is counted and its host time (the call's wall time, which
    for gloo includes staging the CUDA tensor through the host and waiting
    for the peer) added up."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather_single")

    def __init__(self, dist):
        self.dist, self.calls, self.ms, self.saved = dist, 0, 0.0, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def timed(*args, _fn=fn, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.calls += 1
                    self.ms += (time.perf_counter() - t0) * 1e3

            setattr(self.dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _adam_ceiling(lrs: list, wd: float, top: float) -> float:
    """The most two AdamW runs from the same bfloat16 weights can differ by
    in one element of a leaf whose largest |w| is ``top``, after steps at
    the learning rates ``lrs``, whatever their gradients: each update is at
    most 1.01 lr (by Cauchy-Schwarz on the bias-corrected moments, 1.003 at
    b1 0.9, b2 0.95 and up to 5 steps) plus lr x wd x |w|, and each step
    rounds the weight to bfloat16 (half an ulp, 2^-8 of |w|)."""
    return sum(2 * lr * (1.01 + wd * top) + 2 * 2.0 ** -8 * top for lr in lrs)


def _timed_prefills(torch, pre, params, cache, tokens, n: int) -> tuple:
    """``n`` prefills of ``tokens`` into the same cache: the last logits and
    each call's host ms up to a synchronise."""
    times = []
    with torch.no_grad():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = pre(params, cache, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return logits, times


def tp_worker(rank: int, work: Path, seed: int) -> int:
    """One rank of phase train_tp: the partitioned steps and prefills, and,
    on rank 0, the single-device ones it holds them to.  Writes
    ``WORK/tp_rank<RANK>.json``."""
    import dataclasses
    import math

    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch.configs import resolve
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.steps import make_init, make_prefill_step, make_train_step

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=2)
    probe = _probe_gloo(torch, dist, rank)
    check(all(probe.values()), f"gloo does not carry {probe} for CUDA tensors")
    cfg = resolve(TRAIN_TP["arch"])
    rc = dataclasses.replace(train_rc(cfg), microbatches=1)
    opt_cfg = AdamWConfig(state_dtype=rc.opt_state_dtype, weight_decay=rc.weight_decay,
                          grad_clip=rc.grad_clip)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params0, opt0 = make_init(cfg, rc, opt_cfg, device="cuda")(gen)
    batches = [make_batch(cfg, TRAIN_TP["batch"], TRAIN_TP["seq"], seed=seed, step=600 + i)
               for i in range(TRAIN_TP["steps"])]
    mesh = make_mesh(TRAIN_TP["mesh"], ("data", "model"))
    pshard = SH.param_shardings(mesh, M.abstract_params(cfg))
    oshard = SH.opt_state_shardings(mesh, opt0, pshard)
    mshard = pytree.tree_leaves(oshard["m"])

    def gathered(tree, shards):
        return [SH.gather(x, sh) for x, sh in zip(pytree.tree_leaves(tree), shards)]

    step = make_train_step(cfg, rc, opt_cfg, grad_shardings=pshard)
    p2, o2 = SH.place(params0, pshard), SH.place(opt0, oshard)
    zero_counts()
    p2, o2, loss2, ms2, peak2, _rise = _timed_steps(torch, step, p2, o2, batches[:1])
    m_tp = gathered(o2["m"], mshard)
    p2, o2, loss_b, ms_b, peak_b, _rise = _timed_steps(torch, step, p2, o2, batches[1:])
    train_counts = read_counts()
    loss2, ms2, peak2 = loss2 + loss_b, ms2 + ms_b, max(peak2, peak_b)
    check(all(math.isfinite(x) for x in loss2), f"non-finite partitioned losses {loss2}")
    full = gathered(p2, pytree.tree_leaves(pshard))
    holder = {}

    def one_step():
        holder["state"] = step(p2, o2, batches[0])

    with _CollectiveClock(dist) as clock:
        if rank == 0:
            trace = _device_busy(torch, one_step)
        else:
            one_step()
            torch.cuda.synchronize()
    del holder, o2
    trace = {} if rank else dict(trace, collective_calls=clock.calls,
                                 collective_host_ms=clock.ms)

    B, S = SERVE["requests"], SERVE["prompt_len"]
    g = torch.Generator(device="cuda").manual_seed(seed + 60)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    serve = dataclasses.replace(rc, remat="none", flash_vjp=False)
    cache_abs = M.abstract_cache(cfg, B, S)
    cshard = SH.cache_shardings(mesh, cache_abs)
    pre = make_prefill_step(cfg, serve, shardings=(pshard, cshard))
    ppieces = SH.place(params0, pshard)
    cache = SH.place(M.init_cache(cfg, B, S, device="cuda"), cshard)
    zero_counts()
    logits2, prefill_ms = _timed_prefills(torch, pre, ppieces, cache, tokens,
                                          TRAIN_TP["prefills"])
    prefill_counts = read_counts()
    del ppieces, cache
    out = {"rank": rank, "probe": probe, "losses_tp": loss2, "ms_tp": ms2, "peak": peak2,
           "train_counts": train_counts, "prefill_counts": prefill_counts,
           "prefill_ms": prefill_ms, "layers": cfg.n_layers, "heads": cfg.n_heads,
           "local_heads": cfg.n_heads // TRAIN_TP["mesh"][1], "ff": cfg.d_ff,
           "local_ff": cfg.d_ff // TRAIN_TP["mesh"][1], "trace": trace}
    if rank == 0:
        n = TRAIN_TP["steps"]
        check(train_counts == {"fused_conv3x3": 0, "flash_attention": 2 * cfg.n_layers * n,
                               "fused_mlp": 0, "selective_scan": 0,
                               "flash_attention_bwd": cfg.n_layers * n},
              f"the partitioned steps launched {train_counts}, not flash_attention twice "
              f"and flash_attention_bwd once per layer a step ({n} x {cfg.n_layers})")
        n = TRAIN_TP["prefills"]
        check(prefill_counts == {"fused_conv3x3": 0, "flash_attention": cfg.n_layers * n,
                                 "fused_mlp": cfg.n_layers * n, "selective_scan": 0,
                                 "flash_attention_bwd": 0},
              f"the partitioned prefills launched {prefill_counts}, not flash_attention "
              f"and fused_mlp once per layer a prefill ({n} x {cfg.n_layers})")
        single = make_train_step(cfg, rc, opt_cfg)
        p1, o1, loss1, ms1, peak1, _rise = _timed_steps(torch, single, params0, opt0,
                                                        batches[:1])
        m_single = pytree.tree_leaves(o1["m"])
        grad_rel = _rel_l2(torch, [m.float() for m in m_tp], [m.float() for m in m_single])
        del m_tp, m_single
        p1, o1, loss_b, ms_b, peak_b, _rise = _timed_steps(torch, single, p1, o1,
                                                           batches[1:])
        loss1, ms1, peak1 = loss1 + loss_b, ms1 + ms_b, max(peak1, peak_b)
        names = ["/".join(map(str, k)) for k, _ in pytree.tree_flatten_with_path(p1)[0]]
        worst = max(range(len(grad_rel)), key=grad_rel.__getitem__)
        check(max(grad_rel) <= TP_GRAD_TOL,
              f"partitioned first-step gradients: relative L2 {grad_rel[worst]:.4g} at "
              f"{names[worst]} > {TP_GRAD_TOL} (median "
              f"{statistics.median(grad_rel):.4g}; over "
              + ", ".join(f"{names[i]} {r:.3g}" for i, r in enumerate(grad_rel)
                          if r > TP_GRAD_TOL)[:2000] + ")")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss2, loss1))
        check(loss_rel <= TRAIN_PARITY_TOL["bfloat16"],
              f"partitioned losses {loss2} against single-device {loss1}")
        lrs = [float(warmup_cosine(torch.tensor(t), peak_lr=rc.learning_rate,
                                   warmup_steps=rc.warmup_steps))
               for t in range(TRAIN_TP["steps"])]
        share = [float((a.float() - b.float()).abs().max())
                 / _adam_ceiling(lrs, rc.weight_decay, float(b.float().abs().max()))
                 for a, b in zip(full, pytree.tree_leaves(p1))]
        far = max(range(len(share)), key=share.__getitem__)
        check(share[far] <= 1.0,
              f"partitioned parameters: {names[far]} differs from the single-device "
              f"step's by {share[far]:.4g} x what AdamW can move it in "
              f"{TRAIN_TP['steps']} steps")
        del p1, o1, full
        cache = M.init_cache(cfg, B, S, device="cuda")
        logits1, prefill_ms1 = _timed_prefills(torch, make_prefill_step(cfg, serve), params0,
                                               cache, tokens, TRAIN_TP["prefills"])
        diff = float((logits2 - logits1).abs().max())
        top = float(logits1.abs().max())
        check(diff <= PREFILL_TOL["bfloat16"] * top,
              f"partitioned prefill logits differ by {diff} (max |logit| {top})")
        out.update({"losses_single": loss1, "ms_single": ms1, "peak_single": peak1,
                    "grad_rel_l2": grad_rel, "grad_worst": names[worst],
                    "param_share_of_ceiling": share[far], "param_far": names[far],
                    "prefill_max_abs": diff, "prefill_max_logit": top,
                    "prefill_ms_single": prefill_ms1})
    (work / f"tp_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


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

    from repro_torch.core import roofline as RL
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
        training = label == "train" or label.endswith("_train")
        plain_ms = time_ms(torch, {"plain": plain}, 3 if training else REPS)["plain"]
        es = q.element_size()
        shapes = dict(q=tuple(q.shape), kv=tuple(k.shape), itemsize=es, **mask)
        kc = RL.kernel_cost("flash_attention_bwd", **shapes)
        flops, n_bytes = kc.flops, kc.bytes
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
        if training:  # K2's forward with its logsumexp at the training shape
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window or chunk:
                sdpa_mask = dict(attn_mask=ref._visible(Sq, Skv, causal, window, chunk,
                                                        q.device))
            else:
                sdpa_mask = dict(is_causal=causal)

            def fwd_kernel():
                return fused_attention.flash_attention_lse(q, k, v, **mask)

            def fwd_plain():
                return ref.flash_attention_ref(q, k, v, **mask), ref.attention_lse_ref(q, k, **mask)

            def fwd_library():
                return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                      **sdpa_mask)

            want_o, want_lse = fwd_plain()
            got_o, got_lse = fwd_kernel()
            err = float((got_o.float() - want_o.float()).abs().max())
            lse_err = float((got_lse - want_lse).abs().max())
            check(err <= ATT_TOL[dname] * (1 + float(want_o.float().abs().max()))
                  and lse_err <= 1e-4 * (1 + float(want_lse.abs().max())),
                  f"flash_attention with lse at the training shape {label} {shape}: out "
                  f"{err}, lse {lse_err}")
            del want_o, want_lse, got_o, got_lse
            fms, fone = time_kernel(torch, {"kernel": fwd_kernel, "library": fwd_library})
            fplain = time_ms(torch, {"plain": fwd_plain}, 3)["plain"]
            fkc = RL.kernel_cost("flash_attention", **shapes, lse=True)
            fflops, fbytes = fkc.flops, fkc.bytes
            ft_b = spec.memory_seconds(fbytes) * 1e3
            ft_o = spec.compute_seconds(fflops, es) * 1e3
            frow = {"case": f"{label}_forward_lse", "shape": list(shape), "dtype": dname,
                    **mask, "max_abs_err": err, "lse_max_abs_err": lse_err,
                    "ms": fms["kernel"], "call_ms": fone["kernel"], "plain_ms": fplain,
                    "library_ms": fms["library"], "bytes": fbytes, "flops": fflops,
                    "bound_ms": max(ft_b, ft_o),
                    "bound_by": "operations" if ft_o >= ft_b else "bytes"}
            rows.append(frow)
            print(f"train_kernel flash_attention with lse {label} {shape} {dname} causal="
                  f"{int(causal)} w={window} c={chunk}: kernel "
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


def zoo_entries(zoo: list, att_rows: list, mlp_rows: list, scan_rows: list) -> list:
    """The kernels-line entries of phase serve_zoo (``"path": "serve_zoo"``):
    each kernel's launches over the six runs, its times summed over them at
    each run's rows ("<arch>_prefill", "<arch>_decode")."""
    def row(rows, case):
        return next(r for r in rows if r["case"] == case)

    parts = {"flash_attention": [], "fused_mlp": [], "selective_scan": []}
    for run in zoo:
        arch, counts, steps = run["arch"], run["counts"], run["gen"] - 1
        if counts["flash_attention"]:
            parts["flash_attention"].append((row(att_rows, f"{arch}_prefill"),
                                             counts["flash_attention"]))
        for name, rows in (("fused_mlp", mlp_rows), ("selective_scan", scan_rows)):
            per_forward = counts[name] // run["gen"]
            if per_forward:
                parts[name] += [(row(rows, f"{arch}_prefill"), per_forward),
                                (row(rows, f"{arch}_decode"), per_forward * steps)]
    sources = {"flash_attention": "flash_attention.cu", "fused_mlp": "fused_mlp.cu",
               "selective_scan": "mamba_scan.cu"}
    return [dict(serve_entry(name, f"src/repro_torch/kernels/csrc/{sources[name]}",
                             parts[name], sum(run["counts"][name] for run in zoo)),
                 path="serve_zoo") for name in parts]


def train_zoo_entries(zoo: list, bwd_rows: list) -> list:
    """The kernels-line entries of phase train_zoo (``"path":
    "train_zoo"``): flash_attention (its forward with the logsumexp) and
    flash_attention_bwd, each one's launches over the seven runs, its times
    summed over them at each run's rows (:func:`train_zoo_shapes`)."""
    def row(case):
        return next(r for r in bwd_rows if r["case"] == case)

    parts = {"flash_attention": [], "flash_attention_bwd": []}
    for run in zoo:
        per_sublayer = run["counts"]["flash_attention_bwd"]
        n_sub = sum(shape[5] for shape in run["shapes"])
        for label, *_, sublayers in run["shapes"]:
            n = per_sublayer // n_sub * sublayers
            parts["flash_attention"].append((row(f"{label}_forward_lse"), 2 * n))
            parts["flash_attention_bwd"].append((row(label), n))
    sources = {"flash_attention": "flash_attention.cu",
               "flash_attention_bwd": "flash_attention_bwd.cu"}
    return [dict(serve_entry(name, f"src/repro_torch/kernels/csrc/{sources[name]}",
                             parts[name], sum(run["counts"][name] for run in zoo)),
                 path="train_zoo") for name in parts]


def kernels_entry(rows: list, launches: int, spec) -> dict:
    """The fused_conv3x3 entry of the kernels line: times summed over the
    13 layers at the main paths' shapes (batch 8, float32: the forward of
    phase forward and the trained forward of phase vgg_train)."""
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
    parser.add_argument("--tp-worker", nargs=2, metavar=("RANK", "DIR"),
                        help=argparse.SUPPRESS)  # one rank of phase train_tp
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
    if args.tp_worker:
        return tp_worker(int(args.tp_worker[0]), Path(args.tp_worker[1]), args.seed)
    from repro_torch.configs import resolve
    from repro_torch.core.arch import gpu_spec
    from repro_torch.core.ir import vgg16_ir
    from repro_torch.core.planner import plan_model

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32 (TF32 is on)")

    t_start = time.perf_counter()
    clock = PhaseClock()
    card = phase_device(torch)
    clock.lap("device")
    build = phase_build()
    clock.lap("build")
    spec = gpu_spec()
    vgg = vgg16_ir(pool_mode="separate")

    # ---- main path 1, the paper's VGG-16 flow: counts zeroed just before,
    # read just after ----
    zero_counts()
    paper = phase_paper_flow(vgg)
    clock.lap("paper_flow")
    exhaustive, vgg_flow = phase_exhaustive(torch, np, vgg, args.seed)
    clock.lap("exhaustive")
    model, x, forward = phase_forward(torch, args.seed)
    vgg_counts = read_counts()
    check(vgg_counts["fused_conv3x3"] > 0, "the VGG-16 path never launched fused_conv3x3")
    print(f"phase main_path vgg16: launches {vgg_counts}")
    forward["ms"] = time_forward(torch, model, x)
    del model, x
    torch.cuda.empty_cache()
    clock.lap("forward")

    # ---- main path 14, training VGG-16: counts zeroed just before, read just
    # after (its steps run the torch ops; the trained forward runs K1) ----
    zero_counts()
    vgg_train = phase_vgg_train(torch, spec, card, args.seed)
    vgg_train_counts = read_counts()
    check(vgg_train_counts == {"fused_conv3x3": 13, "flash_attention": 0, "fused_mlp": 0,
                               "selective_scan": 0, "flash_attention_bwd": 0},
          f"training VGG-16 launched {vgg_train_counts}, not fused_conv3x3 13 times "
          "(the trained forward) and nothing else")
    print(f"phase main_path vgg_train: launches {vgg_train_counts}")
    torch.cuda.empty_cache()
    clock.lap("vgg_train")

    # ---- main path 4, the grouping search on DAGs: counts zeroed just
    # before, read just after (it runs no kernel of K1-K4) ----
    zero_counts()
    dag, ed_flow = phase_dag_search(torch, np, args.seed)
    dag_counts = read_counts()
    check(not any(dag_counts.values()),
          f"the DAG search path launched kernels: {dag_counts}")
    print(f"phase main_path dag_search: launches {dag_counts}")
    clock.lap("dag_search")

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
    clock.lap("frontend")

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
    clock.lap("fleet")

    # ---- main path 7, the planning service: counts zeroed just before, read
    # just after (it sweeps through run_fleet; no kernel of K1-K4) ----
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as tmp:
        service = phase_service(torch, np, Path(tmp), args.seed)
    service_counts = read_counts()
    check(not any(service_counts.values()),
          f"the service path launched kernels: {service_counts}")
    print(f"phase main_path service: launches {service_counts}")
    clock.lap("service")

    # ---- main path 2, serving qwen3-0.6b: counts zeroed just before, read
    # just after ----
    plans = phase_plan(spec)
    clock.lap("plan")
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
    clock.lap("serve")

    serve_time = phase_serve_time(torch, SERVE, args.seed, PREFILL_TOL)
    torch.cuda.empty_cache()
    clock.lap("serve_time")

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
    clock.lap("serve_ssm")
    ssm_time = phase_serve_time(torch, SERVE_SSM, args.seed, SSM_PREFILL_TOL,
                                SSM_F32_LAYERS, "serve_ssm_time", control=scan_control)
    torch.cuda.empty_cache()
    clock.lap("serve_ssm_time")

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
    clock.lap("serve_moe")
    moe_time = phase_serve_time(torch, SERVE_MOE, args.seed, PREFILL_TOL,
                                MOE_F32_LAYERS, "serve_moe_time",
                                control=attention_control)
    torch.cuda.empty_cache()
    clock.lap("serve_moe_time")

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
    clock.lap("serve_encdec")
    encdec_time = phase_serve_time(torch, SERVE_ENCDEC, args.seed, PREFILL_TOL,
                                   phase="serve_encdec_time", control=attention_control)
    torch.cuda.empty_cache()
    clock.lap("serve_encdec_time")

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
    clock.lap("serve_ring")

    # ---- main path 15, serving the registry's six other families at full
    # width (phase serve_zoo): each run's counts zeroed just before and read
    # just after its serve (checked in the phase) ----
    zoo = phase_serve_zoo(torch, np, args.seed)
    clock.lap("serve_zoo")

    # ---- main path 11, training qwen3-0.6b through launch.train: counts
    # zeroed just before, read just after ----
    train_cfg = resolve(TRAIN_RUN["arch"])
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_run = phase_train(torch, args.seed, Path(tmp))
        train_counts = read_counts()
        clock.lap("train")
        n_steps = train_run["steps_run"] + train_run["redispatches"]
        check(train_counts == train_launches(train_cfg, n_steps, TRAIN_RUN["microbatches"]),
              f"training launched {train_counts}, not flash_attention twice (the forward "
              f"and its recompute) and flash_attention_bwd once per layer per microbatch: "
              f"{n_steps} steps x {train_cfg.n_layers} layers x {TRAIN_RUN['microbatches']}")
        print(f"phase main_path train: launches {train_counts} ({n_steps} train steps x "
              f"{train_cfg.n_layers} layers x {TRAIN_RUN['microbatches']} microbatches: "
              "flash_attention twice each, the forward and its recompute under full "
              "remat, flash_attention_bwd once)")
        train_time = phase_train_time(torch, train_run, args.seed)
        clock.lap("train_time")
        roofline = phase_roofline(torch, card, train_time, serve_time)
        clock.lap("roofline")
        train_parity = phase_train_parity(torch, args.seed)
        torch.cuda.empty_cache()
        clock.lap("train_parity")

        # ---- main path 12, the sharded training path: the counts of its
        # sharded and its compressed steps, each zeroed just before and read
        # just after (checked in the phase); it resumes phase train's
        # checkpoint ----
        train_sharded = phase_train_sharded(torch, args.seed, Path(tmp))
        torch.cuda.empty_cache()
        clock.lap("train_sharded")

    # ---- main path 13, the partitioned training path on two ranks: each
    # rank zeroes the counts just before its steps and its prefill and reads
    # them just after (checked in the phase) ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        train_tp = phase_train_tp(torch, card, args.seed, Path(tmp))
    clock.lap("train_tp")

    # ---- main path 16, training seven more families at full width (phase
    # train_zoo): each run's counts zeroed just before and read just after
    # its training (checked in the phase) ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_zoo_") as tmp:
        train_zoo = phase_train_zoo(torch, args.seed, Path(tmp))
    clock.lap("train_zoo")
    examples = phase_examples(card)
    clock.lap("examples")

    layer_rows = phase_layers(torch, spec, args.seed)
    clock.lap("layers")
    plan = plan_model(qwen, 4096, spec)
    att_rows = phase_attention(torch, spec, args.seed,
                               (plan.attn_block_q, plan.attn_block_k))
    clock.lap("attention")
    mlp_rows = phase_mlp(torch, spec, args.seed, (plan.mlp_block_m, plan.mlp_block_f))
    clock.lap("mlp")
    scan_rows = phase_scan(torch, spec, args.seed)
    clock.lap("scan")
    bwd_rows = phase_train_kernel(torch, spec, args.seed)
    clock.lap("train_kernel")

    def row(rows, case, dtype):
        return next(r for r in rows if r["case"] == case and r.get("dtype") == dtype)

    entries = [
        kernels_entry(layer_rows,
                      vgg_counts["fused_conv3x3"] + vgg_train_counts["fused_conv3x3"], spec),
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
    tpc, tpp = train_tp["train_counts"], train_tp["prefill_counts"]
    entries += [dict(e, path="train_tp") for e in (
        serve_entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                    [(row(att_rows, "tp_train", "bfloat16"), tpc["flash_attention"]),
                     (row(att_rows, "tp_prefill", "bfloat16"), tpp["flash_attention"])],
                    tpc["flash_attention"] + tpp["flash_attention"]),
        serve_entry("fused_mlp", "src/repro_torch/kernels/csrc/fused_mlp.cu",
                    [(row(mlp_rows, "tp_prefill", "bfloat16"), tpp["fused_mlp"])],
                    tpp["fused_mlp"]),
        serve_entry("flash_attention_bwd",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    [(row(bwd_rows, "train_tp", "bfloat16"), tpc["flash_attention_bwd"])],
                    tpc["flash_attention_bwd"]),
    )]

    entries += zoo_entries(zoo, att_rows, mlp_rows, scan_rows)
    entries += train_zoo_entries(train_zoo, bwd_rows)

    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "build": build, "paper_flow": paper,
        "exhaustive": exhaustive, "forward": forward, "vgg_train": vgg_train,
        "vgg_train_counts": vgg_train_counts, "examples": examples, "dag_search": dag,
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
        "train_time": train_time, "roofline": roofline, "train_parity": train_parity,
        "train_sharded": train_sharded, "train_tp": train_tp,
        "attention": att_rows, "mlp": mlp_rows, "scan": scan_rows,
        "train_kernel": bwd_rows, "serve_zoo": zoo, "train_zoo": train_zoo,
        "kernels": entries,
        "phase_seconds": clock.seconds, "seconds": time.perf_counter() - t_start,
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
