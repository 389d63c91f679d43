#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (internnav_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers:
  1. build   — compile every CUDA kernel from csrc/ (one nvcc per source,
               all started together) and print ptxas registers / spills;
  2. kernels — hold each kernel against its plain PyTorch version and time
               both: K1 at the serving shapes (a prompt bucket, a ragged
               prompt, a batched cohort's 12 prompts, a vision image;
               beside SDPA with the same boolean mask and the bound); K1,
               K2 and K3 at the training
               head shape (28 heads, 4 KV heads, D=128, causal, segment ids of
               a real packed row) at T=2048, a ragged T and T=8192 (K1's
               plain version in query chunks), with the live and causal
               tiles per head of each row and K1's walked tiles counted by
               the kernel itself; the kernels' times beside the plain
               version's, the bound and scaled_dot_product_attention's
               forward (a yardstick), at T=8192 also the whole backward
               (D_i + K2 + K3 through FlashAttentionFn) beside SDPA's;
               then a dense causal T=8192
               row (no segment ids, where no tile can be skipped: the rate)
               checked and timed beside SDPA with is_causal; then the int8
               kernels of the realtime profile at the 7B shapes, those of
               the serve batched path (below) included: K6a
               (activation quantization fused into the op before it: the
               RMSNorm with and without the residual add, the SwiGLU
               product, and bf16 / fp32 rows as they are; the differing
               RMSNorm codes counted) at a token, the shared decode and
               its latent chunk, a prompt and a batched cohort's prefill;
               K6b (W8A8 GEMM: the decode tiles at M = 1, 4 and 12 per
               projection of a layer, q/k/v and gate/up fused into one
               launch and held bitwise equal to their separate launches,
               warm and with a cold L2; the prefill tiles at M = 48 and
               192 (the shared decode and its latent chunk), the 4th
               request's and the long request's prompt and a batched
               cohort's prefill beside torch._int_mm; the lm_head at 1,
               12 and 48 rows; odd N at decode and prefill), K4/K5 (int8
               decode attention at the serving caches, past 4,096 keys, a
               ragged batch of 3, 8 queries a head, and a batched cohort's
               12 rows) and K7 (rotary + KV quantization + cache write for
               a token, the latent chunk, a ragged batch of 3 with a
               dropped row and past the cache's end, a batched cohort's
               12 rows; the prompts' writes without rotary), and K8 (the
               bf16 SiLU with XLA's roundings, alone or times up, bitwise)
               at a parity decode token's, a parity prompt's and the train
               row's SwiGLU, a frame's vision MLP, a stream's NextDiT
               feed-forward and the time embedding, at a length that is no
               multiple of 8 and on inputs no 16-byte boundary aligns; K9
               (W4A8 GEMM, packed int4 codes, grouped-128) for a layer's
               q/k/v and gate/up fused and o and down at M = 1, 4, 12 and
               48 (its decode ring, warm and cold), each projection alone
               at 192, 1088 and 4864 (its prefill tiles), per channel
               bitwise, odd N (63, 65, 4097); K10 (W8A16 / W4A16 GEMM)
               fused likewise at M = 1, 4, 12, 48 and 192 with int8
               per-channel and int4 grouped codes, the gate alone at M =
               1, and the lm_head at 1, 12 and 48 rows (int8 per channel,
               8-bit grouped); K10 beside torch._weight_int8pack_mm
               (per-channel int8) and torch._weight_int4pack_mm (grouped
               int4), each checked against the plain version, and K9's
               grouped rows beside the latter on the same rows in bf16 (a
               fused row's call on its projections' codes stacked along
               N); then a row's bits held equal across M, whole-K and
               split plans and fused and separate launches (K9, K10);
  3. serve   — build the full-width Qwen2.5-VL-7B InternVLA-N1 policy in the
               `parity` profile (bf16, random weights from a seeded
               generator), serve it through the real-robot HTTP server and
               POST /reset + 4 /eval_dual requests; K1 must have launched
               during the requests, and no int8 kernel; K8 as computed
               from the frames, layer passes and System-1 calls;
  serve tp — multi-GPU serving at world size 1 (the machine has one
               card): serve parity's 4 System-2 prompts greedy-decoded
               (MAX_NEW_TOKENS) by the parity policy as it is, then with
               its decoder laid out for serving (`apply_serve_tp`) over
               the tp group of a dp=1 x tp=1 mesh of a one-rank NCCL
               group (the all-reduces and the vocab argmax reduce inside
               the captured decode step); tokens, lengths and traj latents
               bitwise equal, K1 launched once a prefill layer on the
               local heads; each request's seconds;
  checkpoint — the parity policy written as an HF-layout sharded
               safetensors checkpoint (`convert.hf_state_dict`, 5 GiB
               shards and the index) in TMPDIR (or build/chip_smoke when
               TMPDIR lacks the room; the run fails when neither has
               it), after each tensor's sha256 is taken; then the realtime
               policy of seed 0 built (its digests and peak device
               memory) and freed, and the realtime policy loaded from the
               checkpoint, quantized on load: every tensor equal by
               digest, the load's peak device memory at most the build's;
               GB, seconds and GB/s of the write and the load; after serve
               realtime the loaded int8 policy saved natively
               (`save_pretrained`). The directories are removed at the
               end, whatever happens;
  4. serve realtime — the same with the policy loaded from the checkpoint
               through `serve.build_policy("realtime", ckpt=...)` (W8A8
               projections, int8 KV cache): the launches of K1, K4, K5,
               K6a (and of each of its prologues), K6b and K7 must equal
               the counts computed from
               the layers and each request's decode steps (K6b: 4 per
               decode or chunk layer pass, 7 per prefill layer pass, one
               per lm_head call); then, after
               /reset and 8 uncounted 644x644 frames with a short decode
               budget, the long request (the
               ninth frame: a 4,864-token prompt, a 4,996-key cache), its
               launches counted on their own; the decode loop replays a
               captured CUDA graph a step, and each request's replays,
               captures and warm-up steps are checked; then W8A16 decode
               on the same policy (decode_act_dtype="bf16": 2 requests,
               K10 for every decode and chunk projection and each decode
               step's lm_head, no K6a at decode; one request replayed
               from the graph and run eagerly, bit for bit); a decode
               step against a re-prefill of the same tokens (bf16 KV,
               plain prefill attention) within 2e-2, and with K1 in the
               re-prefill within half the largest logit;
  int4     — the HF checkpoint loaded again quantized on load to int4
               (W4A8: packed codes, grouped-128 scales, the lm_head at 8
               bits), held equal by digest to the int4 seed-0 build,
               saved natively and served from that directory through
               `serve.build_policy("realtime", ckpt=...)`: 4 requests, K9
               4 a decode layer pass (2 fused) and 7 a prefill one, K6b
               only for the lm_head, K10 none; a
               decode step against a re-prefill of the same tokens (bf16
               KV, plain prefill attention) within 2e-2, with K1 within
               twice the W8A8 policy's gap; W4A16 decode as above;
  5. serve batched — the JAX package's headline serving geometry: the 7B
               realtime policy behind PipelinedN1Server, 4 cohorts x 12
               streams, 224x224 frames, histories saturated at 9 frames,
               shared grouped decode of 20 tokens (the stop id pinned so
               that every cycle decodes them all), 2 System-1 calls a
               cycle; checked cycles with every stream's own inputs (graph
               replay bitwise equal to eager decode; shared decode equal
               to per-cohort decode), then 1 timed stream of 5 cycles:
               actions/s, host seconds by call, peak memory, and every
               kernel's launches, K8's (the vision tower's and System-1's
               SiLU) included, equal to the computed counts;
  6. evaluate — the evaluator-path headline through the bench entry
               (scripts/torch/bench_evaluator.py), its policy loaded from
               the native int8 checkpoint and held equal by digest to the
               realtime build: VLNPipelinedEvaluator
               over FakeEnv driving BatchedInternVLAN1Agent cohorts on the
               7B realtime policy, 4 cohorts x 12 streams, 224x224,
               max_step 24, shared grouped decode of 20 tokens (stop id
               -7), per-cohort System-1, barrier env apply; one warm run
               and EVAL_RUNS (2) timed runs: actions/s per run and their
               median,
               p50/p99 action latency, the agents' System-2 and System-1
               calls, the decode graph's captures and replays, peak
               memory; every episode must end, every action be one of the
               four and every trajectory finite and well formed, K1, K4,
               K5, K6a, K6b, K7 and K8 must launch in the timed runs, and no
               plain version of a kernel (the `*_reference` functions of
               ops/, and `quant.quantize_rows`) may run in the phase; the
               warm run's launches are logged by signature (`ShapeLog`:
               prompt buckets, decode groups' rows and Tmax, K6b's rows
               and projections, K8's rows and widths; every launch
               accounted for), and after the
               timed runs each kernel is checked against its plain version
               and timed at its most launched signatures (kernel rows
               with path=evaluate); then the int4 loop (`bench_evaluator.py
               --weight-dtype int4 --ckpt <native int4>`): a warm run and
               one timed run of SHORT_MAX_STEP (12) steps, K9 and the
               lm_head's K6b launched, no K10,
               no plain version; then evaluate server, the reference's
               client-server layout: `AgentServer` on a thread of this
               process, `scripts/torch/eval.py --config` as a subprocess
               with use_agent_server over 2 FakeEnv episodes (at most 16
               steps, 224x224), the server's "internvla_n1" agent built
               from the native int8 checkpoint on the card: exit 0, 2
               finite episodes in result.json, K1 and K4-K8 launched in
               the server, no plain version, actions/s; then evaluate
               habitat, the reference's VLN-CE and VL-LN protocols over
               NavmeshFakeSim at 420x420: `Evaluator.init` with the
               "internvla_n1" agent from the native int8 checkpoint
               (habitat_dual_system_cfg.py's settings), dual_system over 2
               episodes of at most 32 steps (then resumed from its
               progress.json: nothing re-run), system2 over one (the
               navmesh snap and follower), `HabitatDialogEvaluator` with a
               `DialogAgent` around the same policy over one; the policy
               decodes in full, its texts scripted (a pixel goal, an
               action list, STOP, a question its SimpleNPC answers) so
               that each branch runs; the look-down capture balanced,
               every action legal, the metrics finite, K1 and K4-K8 held
               to the counts computed from the System-2 / System-1 calls
               and the frames, no plain version; and one request through
               `s2_step(fused=False)` against `fused=True` on the same
               frame: tokens equal, each traj query's latents within
               UNFUSED_LATENT_RTOL; then evaluate vln_pe, the reference's
               VLN-PE protocol (InternUtopia physics) without a simulator
               (FakePhysicsVecEnv) on the same checkpoint: (a) flash,
               `scripts/torch/eval.py`'s main in this process on the h1
               InternVLA-N1 config with backend fake_physics and a 420x420
               camera, 2 episodes of data/fake_r2r in one env of at most
               32 steps, then again (the resume: nothing re-run); (b)
               physical, one episode of at most 8 macro steps of 50
               substeps, the H1 loco actor on the card every 4th substep,
               its joint targets held against the same actor on the host
               within LOCO_TOL; (c) the pipelined evaluator's internutopia
               cohorts: 2 x 4 FakePhysics envs at 224x224 behind
               VLNPEBatchAdapter, the batched agent over the shared
               grouped decode, 8 episodes of at most 16 steps; every
               action legal, every episode ended with finite metrics, K1
               and K4-K8 held per part to the counts computed from the
               System-2 / System-1 calls and the frames
               (`expected_serve_launches`, `expected_pipelined_launches`),
               no plain version. Python's str hash is pinned
               (PYTHONHASHSEED=0; the script re-executes itself with it),
               so FakeEnv and FakePhysicsVecEnv draw the same frames in
               every run; then evaluate recurrent, the reference's
               recurrent VLN baselines CMA and Seq2Seq at their published
               width (ResNet-50 RGB at 224x224, the DD-PPO GroupNorm
               ResNet-50 depth tower at 256x256, a bi-LSTM over 2504 x 50
               embeddings, GRUs of 512; fp32), random weights from seed 0
               (the action head centred so that episodes take steps)
               written as reference-layout checkpoints: (a) eval.py's main
               on `h1_cma_cfg.py`, 4 FakeEnv envs, 8 episodes of
               data/fake_r2r of at most 32 steps, then the resume; (b)
               the same on `h1_seq2seq_cfg.py`; (c) the pipelined
               evaluator, 2 cohorts x 4 envs of "cma" agents on one
               shared policy; (d) a CMA and a Seq2Seq forward at 4 envs
               against the same checkpoints on the host within
               RECURRENT_TOL; every action legal, every episode ended with
               finite metrics, K1-K10 launched 0 times and no plain
               version run; a step's seconds at 4 and 8 envs, one
               profiled step's device ms and launches, actions/s, peak
               memory; then train recurrent (a fixture LMDB written by the
               port's LMDBWriter, lmdb_to_store.py, train.py's main for
               CMA and Seq2Seq, 4 steps each at cma_cfg's batch, the saved
               policies reloaded bitwise), evaluate rdp (a seed-0 RDP at
               rdp_cfg's width as a reference-layout checkpoint, its
               denoiser's dx and stop heads biased so that episodes run
               to their 32 steps: eval.py on h1_rdp_cfg.py, 4 FakeEnv envs,
               8 episodes, mid-episode cache refills, the resume; one act
               call card against host within RDP_TOL, timed and profiled)
               and train rdp (4 steps at batch 8, the EMA moved off its
               start and apart from the parameters); then evaluate
               navdp_vn (standalone NavDP at navdp_cfg's width as a
               reference-layout checkpoint, the "navdp" agent through the
               VN pointgoal evaluator over 3 episodes, one replan card
               against host within NAVDP_VN_TOL, timed and profiled),
               train navdp (train.py on navdp_train_cfg.py, 4 steps at
               batch 16 over a synthetic 224x224 store, the EMA on, the
               policy reloaded bitwise) and dpt (DepthAnythingV2 at
               518x518 through its reference-layout converter, card
               against host within DPT_TOL); K1-K10 launched 0 times in
               each, no plain version;
  navdp    — the NavDP System-1 (`navdp_async`: the fp32 NavDP head with
               its RGBD backbone and 20-step DDPM) on one 7B realtime
               policy (random weights, seed 0): serve navdp, 4
               /eval_dual requests with depth at 420x420 (System-1's
               frames fitted to 224), every trajectory finite, K1 and
               K4-K8 held to the computed counts (the head has no SiLU),
               no plain version run, each System-1 call's seconds; the
               head on the card against its copy on the host (1 stream,
               32 samples, injected noise, fp32, cuDNN TF32 at PyTorch's
               default so the head's own guard keeps the towers fp32)
               within NAVDP_TOL, beside two unchecked TF32 control
               readings of the same call; serve
               batched navdp (PipelinedN1Server, 4 cohorts x 12 streams of
               224x224 RGBD pairs, the shared grouped decode and the shared
               grouped System-1): a warm cycle, a checked cycle (launches
               held to the computed counts, each grouped 48-stream call
               timed), the same cycle with per-cohort System-1
               (trajectories within NAVDP_GROUPED_TOL, action differences
               counted), the warm cycle's last grouped call profiled
               (device ms, launches);
               evaluate navdp (`bench_evaluator.py --system1 navdp_async`'s
               functions, 4 x 12, a warm and one timed run of
               SHORT_MAX_STEP (12) steps: actions/s,
               System-1's host seconds, K1 and K4-K8 launched, no plain
               version);
  7. train   — with the serving policies freed: the full-width 7B
               `nextdit_async` policy at TRAIN_LAYERS decoder layers with
               remat, loaded from the HF-layout checkpoint through the
               train launcher's `--ckpt` route (`train_n1.build_policy`)
               and held equal by digest to the parity build, one packed
               8192-token row from a synthetic store through
               `InternVLAN1Trainer.prepare_batch`, one untimed and 3 timed
               optimizer steps (chunked CE 1024, bf16 Adam moments, vision
               frozen); each timed step must launch K1 2·L times and K2, K3
               L times each;
  8. train sharded — the same policy through the sharded trainer on this
               one card: a one-rank NCCL process group (MASTER_ADDR and
               MASTER_PORT set where absent), mesh {"dp": 1, "tp": 1},
               param_sharding "tp" with fsdp_rest (the decoder's
               projections, the embedding and the lm_head tensor-parallel
               DTensors, the rest under FSDP2), grad_accum_steps 2 and the
               EMA; at every layer unless its peak, reckoned from phase
               train's measured peak of a micro-batch accumulated into
               held gradients plus the bf16 EMA, passes
               SHARDED_PEAK_LIMIT_GIB (then the fewest layers cut); two
               optimizer steps over two packed 8192-token rows, one
               micro-batch a row. Held: K1/K2/K3 launched (2·L, L, L) times a
               micro-batch; step 1's lm_loss against the two rows'
               forward-only token mean with the same parameters
               (SHARDED_LOSS_RTOL), which the mean of the two rows' own
               means, the reduction a per-row loss would give, must miss
               (a control); the EMA equal to the parameters after
               step 1 (decay 0) and to d·e + (1 − d)·p after step 2 on the
               sampled parameters (EMA_BF16_TOL); the frozen tower
               unchanged; no plain version run; step s, tokens/s, MFU and
               peak memory printed.
Every kernel's launch count is set to 0 just before each of the
twenty-five paths (serve, serve tp, serve realtime, the long realtime request, serve
realtime W8A16, serve int4, serve W4A16, serve batched's timed stream, the
evaluate phase's timed runs, the int4 evaluate's timed run, evaluate
server, evaluate habitat, evaluate vln_pe (each of its three parts),
evaluate recurrent (each of its parts, where every count must stay 0),
train recurrent, evaluate rdp, train rdp, evaluate navdp_vn, train navdp,
dpt (every count 0 in each), serve navdp,
serve batched navdp's checked cycle, evaluate navdp's timed run, train,
train sharded's two steps) and read just after. Then one JSON
line of kernel results, the GPU's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; with no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

K1_SOURCE = "internnav_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "internnav_tpu_torch/csrc/flash_bwd.cu"
K1_REPLACES = "internnav_tpu/ops/flash_attention.py:79"
K2_REPLACES = "internnav_tpu/ops/flash_attention.py:260"
K3_REPLACES = "internnav_tpu/ops/flash_attention.py:314"
K6A_SOURCE = "internnav_tpu_torch/csrc/quantize_rows.cu"
K7_SOURCE = "internnav_tpu_torch/csrc/rope_kv_write.cu"
GEMM_SOURCE = "internnav_tpu_torch/csrc/w8a8_gemm.cu"
DECODE_SOURCE = "internnav_tpu_torch/csrc/decode_int8.cu"
QWEN_TEXT = "internnav_tpu/model/basemodel/internvla_n1/qwen_text.py"
K4_REPLACES = "internnav_tpu/ops/flash_attention.py:548"
K5_REPLACES = "internnav_tpu/ops/flash_attention.py:589"
K6A_REPLACES = f"{QWEN_TEXT}:173"
K6B_REPLACES = f"{QWEN_TEXT}:177"
K7_REPLACES = f"{QWEN_TEXT}:527"
K8_REPLACES = f"{QWEN_TEXT}:597"
K9_SOURCE = "internnav_tpu_torch/csrc/w4a8_gemm.cu"
K10_SOURCE = "internnav_tpu_torch/csrc/w8a16_gemm.cu"
K9_REPLACES = f"{QWEN_TEXT}:140"  # the s4 -> s8 widening, then the int8 dot of :177-196
K10_REPLACES = f"{QWEN_TEXT}:153"
K1_ATOL = K1_RTOL = 2e-2   # o: bf16 output rounding + bf16 P in the P.V product
LSE_ATOL = 1e-3            # lse: fp32 statistics from the same bf16 inputs
# dq/dk/dv: bf16 outputs, and P / dS rounded to bf16 as tensor-core operands
# and summed over up to T terms: atol 1% of the largest plain-version entry
# (at least 1e-2) plus rtol 2%
BWD_ATOL_FRAC = 1e-2
BWD_RTOL = 2e-2
# K6a's SWIGLU and PLAIN prologues and K7 are bitwise (the plain versions'
# expf / rsqrtf, IEEE divisions, bf16 roundings and round half to even);
# K6a's RMSNORM codes within +-1 and scales within 2^-7 (its sum of squares
# in another order than ATen's mean; x + h bitwise); K6b per-channel
# bitwise (exact int32 sums, the same fp32 epilogue in the same order),
# grouped at 1e-2 (the sum over groups in another order); K4/K5 at 2e-2,
# as K1
GROUPED_TOL = 1e-2
DECODE_TOL = 2e-2
REPREFILL_TOL = 2e-2  # decode against re-prefill: JAX's tests/test_int8_decode.py:268-270
# the same gap with K1 in the re-prefill: K1 rounds P to bf16 (as the
# Pallas kernel does, flash_attention.py:143), which the int8 codes of 28
# layers carry to about 1.2 of logits up to 5.3 on an H100 (W8A8 1.256,
# W4A8 1.14-1.18): held within this share of the largest logit,
# and the int4 policy's within K1_GAP_FACTOR times the W8A8 policy's
K1_GAP_LOGIT_FRAC = 0.5
K1_GAP_FACTOR = 2.0
INSTRUCTION = "go past the table and stop at the second door on the left"
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12    # dense int8 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
# realtime serving shapes: a bucketed prompt at the 4th request, the decode
# budget and the traj-latent chunk
PROMPT_T = 1088
MAX_NEW_TOKENS = 128
N_QUERY = 4
# the long realtime request: the ninth 644x644 frame of an episode, whose
# prompt holds 8 history frames and the current one (9 x 529 image tokens),
# bucketed to LONG_PROMPT_T tokens (past 4,096 - 132); the 8 frames before
# it take WARMUP_NEW_TOKENS decode steps
LONG_HW = 644
LONG_FRAMES = 9
LONG_PROMPT_T = 4864
WARMUP_NEW_TOKENS = 4
# the batched serving headline (the JAX package's bench.py
# `bench_pipelined`, docs/BENCH_METHOD.md): 4 cohorts x 12 streams
BATCH_COHORTS = 4
BATCH_ROWS = 12
BATCH_HW = 224
BATCH_NEW_TOKENS = 20
BATCH_TRAJS = 32
BATCH_S1_CALLS = 2
BATCH_CYCLES = 5
BATCH_STREAMS = 1
ACTIONS_PER_CYCLE = 8
# its prompt (9 frames of 64 image tokens and the instruction), the prompt's
# 32-token bucket and the cache slots of a row (checked on the path)
BATCH_PROMPT = 668
BATCH_PROMPT_T = 672
BATCH_TMAX = BATCH_PROMPT_T + BATCH_NEW_TOKENS + N_QUERY
BATCH_DECODE_M = BATCH_COHORTS * BATCH_ROWS  # the shared decode's rows
# the shared decode against the per-cohort decode: tokens exactly equal;
# latents within this, for a row-wise reduction outside the hand-written
# kernels (the final RMSNorm) may sum in another order at 48 rows than at
# 12 (a bf16 ulp or two)
SHARED_TOL = 1e-2
TRAIN_LEN = 8192
TRAIN_LAYERS = 28
TRAIN_HW = 224
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
QUEUE_CYCLES = 10_000_000  # device sleep ahead of each timed call (~5 ms at 1.98 GHz)
HASH_SEED = "0"  # PYTHONHASHSEED of the run (the bench entry's HASH_SEED)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


_FLUSH = []  # the buffer `cuda_ms(cold=True)` writes, made once


def cuda_ms(fn, reps: int = 20, cold: bool = False) -> float:
    """Device milliseconds of one fn() call: the median of `reps` CUDA-event
    timings (after one warm-up). Each call is queued behind a device-side
    sleep (QUEUE_CYCLES, ~5 ms), so the host has enqueued the call's
    launches before the device reaches them, and the events time the
    device's work alone rather than the host's launch overhead. With
    `cold`, a 128 MB buffer is written between the sleep and the start
    event, so fn's operands come from device memory, not the 50 MB L2 (as
    a decode step meets each layer's weights)."""
    import torch

    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda"))
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        if cold:
            _FLUSH[0].fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build() -> None:
    from internnav_tpu_torch.ops import _build

    sources = ("flash_fwd.cu", "flash_bwd.cu", "w8a8_gemm.cu", "decode_int8.cu",
               "quantize_rows.cu", "rope_kv_write.cu", "w4a8_gemm.cu", "w8a16_gemm.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load_library, sources))
    seconds = time.perf_counter() - t0
    for src in sources:
        log = _build.library_path(src).with_suffix(".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"ptxas {log.stem}: {line.strip()}")
    print(f"phase build: gpu={gpu_line()!r} seconds={seconds:.2f}")


# ------------------------------------------------------------------ data
def synthetic_store() -> str:
    """The training store of bench.py's train measurement: 24 episodes of
    up to 10 steps, 224x224 frames, seed 0 (written once per run)."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import write_synthetic_n1_dataset

    path = WORK_DIR / "train_store.bin"
    for p in (path, Path(f"{path}.size")):
        p.unlink(missing_ok=True)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    return write_synthetic_n1_dataset(str(path), n_episodes=24, T=10, hw=TRAIN_HW)


def packed_row(store: str, max_len: int) -> dict:
    """One packed SFT row of `max_len` tokens at the 7B vocab (2 history
    frames), filled as bench.py fills it."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import (
        N1SampleDataset,
        n1_packed_collate_fn,
        tokenize_sample,
    )
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import SimpleTokenizer

    cfg = InternVLAN1Config.qwen25vl_7b()
    tok = SimpleTokenizer(cfg.text.vocab_size)
    tpi = (TRAIN_HW // cfg.vision.patch_size // cfg.vision.spatial_merge_size) ** 2
    rows, total = [], 0
    for s in N1SampleDataset(store, predict_step_nums=cfg.predict_step_nums, num_history=2):
        rows.append(tokenize_sample(s, tok, tokens_per_image=tpi, n_query=cfg.n_query))
        total += len(rows[-1]["input_ids"])
        if total >= max_len + 2048:
            break
    return n1_packed_collate_fn(rows, max_len=max_len, predict_step_nums=cfg.predict_step_nums)


def valid_pairs(seg, causal: bool) -> int:
    """(query, key) pairs the masks keep, summed over the batch rows."""
    import numpy as np

    total = 0
    for row in np.asarray(seg):
        _, counts = np.unique(row, return_counts=True)
        c = counts.astype(np.int64)
        total += int((c * (c + 1) // 2).sum() if causal else (c * c).sum())
    return total


def bound(kind: str, q, k, pairs: int):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the HBM rate and
    its tensor-core flops over the bf16 peak."""
    B, H, T, D = q.shape
    KV = k.shape[1]
    qo = B * H * T * D * 2           # one bf16 (B, H, T, D) tensor
    kv = B * KV * T * D * 2          # one bf16 (B, KV, T, D) tensor
    stat = B * H * T * 4             # one fp32 (B, H, T) tensor
    seg = 2 * B * T * 4
    if kind == "fwd":      # q, k, v, seg in; o, lse out; S and P.V
        nbytes, flops = 2 * qo + 2 * kv + stat + seg, 4 * D * H * pairs
    elif kind == "dkv":    # q, do, k, v, lse, di, seg in; dk, dv out; S, dP, dV, dK
        nbytes, flops = 2 * qo + 4 * kv + 2 * stat + seg, 8 * D * H * pairs
    else:                  # q, do, k, v, lse, di, seg in; dq out; S, dP, dQ
        nbytes, flops = 3 * qo + 2 * kv + 2 * stat + seg, 6 * D * H * pairs
    t_bytes, t_flops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


# --------------------------------------------------------------- kernels
def k1_cases(device):
    """(name, q, k, v, segment_ids, causal) at the serving path's shapes."""
    import numpy as np
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import vision_indices

    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    cases = []
    for T in (2112, 329):  # text prefill bucket, and a ragged length
        seg = torch.zeros((1, T), dtype=torch.int32, device=device)
        seg[:, T - 23:] = 1  # right pad of the prompt bucket
        cases.append((f"text_T{T}", rnd(1, 28, T, 128), rnd(1, 4, T, 128),
                      rnd(1, 4, T, 128), seg, True))
    # the batched prefill: a cohort's 12 prompts in their bucket
    seg = torch.zeros((BATCH_ROWS, BATCH_PROMPT_T), dtype=torch.int32, device=device)
    seg[:, BATCH_PROMPT:] = 1
    cases.append((f"text_B{BATCH_ROWS}_T{BATCH_PROMPT_T}",
                  rnd(BATCH_ROWS, 28, BATCH_PROMPT_T, 128),
                  rnd(BATCH_ROWS, 4, BATCH_PROMPT_T, 128),
                  rnd(BATCH_ROWS, 4, BATCH_PROMPT_T, 128), seg, True))
    win = vision_indices((14, 2, 112), ((1, 30, 30),))["window_segments"]
    seg = torch.as_tensor(np.asarray(win)[None], dtype=torch.int32, device=device)
    cases.append(("vision_S900", rnd(1, 16, 900, 80), rnd(1, 16, 900, 80),
                  rnd(1, 16, 900, 80), seg, False))
    return cases


def chunked_reference(q, k, v, seg, causal: bool, chunk: int = 1024):
    """K1's plain version (`mha_reference` in fp32) over query chunks, so
    that a T=8192 row holds (chunk x T) scores at a time: chunk [i, i + c)
    against keys [0, i + c) under the causal mask (the plain version's
    bottom-right convention, equal here to the global top-left mask), or
    against every key. Returns (o, lse)."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    outs, lses = [], []
    T = q.shape[2]
    for i in range(0, T, chunk):
        end = min(i + chunk, T)
        kv_end = end if causal else k.shape[2]
        o, lse = fa.mha_reference(
            q[:, :, i:end].float(), k[:, :, :kv_end].float(), v[:, :, :kv_end].float(),
            causal=causal, segment_ids=None if seg is None else seg[:, i:end],
            kv_segment_ids=None if seg is None else seg[:, :kv_end], return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def k1_tiles(q, k, seg, causal):
    """(live, causal) key tiles per head that K1 walks: (128-query block,
    64-key tile) pairs of the liveness rule, counted on the CPU."""
    from internnav_tpu_torch.ops import flash_attention as fa

    Tq, Tk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, query_block=fa.FWD_QUERY_BLOCK)
    return (fa.live_tile_pairs(Tq, Tk, segment_ids=None if seg is None else seg.cpu(), **kw),
            fa.live_tile_pairs(Tq, Tk, **kw))


def check_k1(name, q, k, v, seg, causal):
    """K1 against the plain version, and its walked key tiles against the
    CPU count; returns (o, lse, max_abs_err, lse_err)."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    walked = torch.zeros(1, dtype=torch.int32, device=q.device)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg,
                                     tile_counter=walked)
    ref_o, ref_lse = chunked_reference(q, k, v, seg, causal)
    torch.cuda.synchronize()
    want = k1_tiles(q, k, seg, causal)[0] * q.shape[1]
    if int(walked) != want:
        raise AssertionError(f"K1 {name}: walked {int(walked)} key tiles, the CPU rule keeps {want}")
    err = (o.float() - ref_o).abs().max().item()
    if not torch.allclose(o.float(), ref_o, atol=K1_ATOL, rtol=K1_RTOL):
        raise AssertionError(f"K1 {name}: o differs from the plain version by {err}")
    finite = torch.isfinite(ref_lse)
    if not torch.equal(torch.isfinite(lse), finite):
        raise AssertionError(f"K1 {name}: -inf rows of lse differ")
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
    if lse_err > LSE_ATOL:
        raise AssertionError(f"K1 {name}: lse differs by {lse_err}")
    return o, lse, err, lse_err


def check_bwd(name, q, k, v, seg, causal, o, lse, do):
    """K2 and K3 against the plain backward; returns (K2 err, K3 err)."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    di = (o.float() * do.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal=causal, segment_ids=seg)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    ref = fa.flash_backward_reference(q, k, v, seg, seg, o, lse, do, causal)
    errs = {}
    for grad, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        got, want = got.float(), want.float()
        errs[grad] = (got - want).abs().max().item()
        atol = BWD_ATOL_FRAC * max(want.abs().max().item(), 1.0)
        if not torch.isfinite(got).all() or not torch.allclose(got, want, atol=atol,
                                                               rtol=BWD_RTOL):
            raise AssertionError(f"{name}: {grad} differs from the plain backward by "
                                 f"{errs[grad]} (atol {atol})")
    return max(errs["dk"], errs["dv"]), errs["dq"]


def _sdpa_args(q, k, v, seg, causal: bool):
    """K/V repeated per query head, and a boolean mask (or is_causal when
    seg is None) for scaled_dot_product_attention."""
    import torch

    G = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    T = q.shape[2]
    kw = {"is_causal": causal}
    if seg is not None:
        mask = seg[:, :, None] == seg[:, None, :]
        if causal:
            mask = mask & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()[None]
        kw = {"attn_mask": mask[:, None]}
    return kr, vr, kw


def sdpa_fwd_ms(q, kr, vr, kw) -> float:
    """scaled_dot_product_attention's forward on q and `_sdpa_args`' K/V and
    mask. A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    return cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, **kw), reps=10)


def sdpa_bwd_ms(q, kr, vr, kw, do) -> float:
    """scaled_dot_product_attention's backward (dq, dk, dv) on the same
    arguments. A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    o = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    return cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), reps=10)


def flash_backward_ms(q, k, v, seg, do) -> float:
    """The whole backward as the train step runs it: FlashAttentionFn's
    backward (D_i, then K2 and K3 on the forward's tile tables) on K1's
    output, causal."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = fa.FlashAttentionFn.apply(qg, kg, vg, seg, seg, True, None)
    return cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))


def k1_row(name, q, k, v, seg, causal, extra=None) -> dict:
    """K1 at one serving shape (segment ids `seg`): checked against the
    plain version (`check_k1`), timed beside the plain version, SDPA and
    the bound; the row, also printed."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    _, _, err, lse_err = check_k1(name, q, k, v, seg, causal)
    tabs = fa.segment_tile_tables(seg)  # made once per segment set, as the model does
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg,
                                                 tile_tables=tabs))
    plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, causal=causal, segment_ids=seg))
    live, causal_tiles = k1_tiles(q, k, seg, causal)
    one_segment = torch.zeros(q.shape[0], q.shape[2])
    bound_ms, bound_by = bound("fwd", q, k, valid_pairs(one_segment if seg is None
                                                        else seg.cpu(), causal))
    row = {"shape": name, "q": list(q.shape), "kv_heads": k.shape[1], "causal": causal,
           "max_abs_err": err, "lse_max_abs_err": lse_err, "live_tiles": live,
           "causal_tiles": causal_tiles, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": sdpa_fwd_ms(q, *_sdpa_args(q, k, v, seg, causal)), **(extra or {})}
    print("phase kernels: K1 " + " ".join(
        f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
        for key, val in row.items()) + f" gpu={gpu_line()!r}")
    return row


def phase_kernels(device, store) -> dict:
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    k1_rows = [k1_row(*case) for case in k1_cases(device)]

    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    errs = {"fwd": [], "dkv": [], "dq": []}
    train_rows = []
    # training heads at T=2048, 1000 (ragged: not a multiple of 64) and
    # 8192 on packed rows, then a dense causal 8192 row (no segment ids)
    for T, packed in ((2048, True), (1000, True), (TRAIN_LEN, True), (TRAIN_LEN, False)):
        seg = torch.as_tensor(packed_row(store, T)["segment_ids"], device=device) if packed \
            else None
        q, k, v, do = rnd(1, 28, T, 128), rnd(1, 4, T, 128), rnd(1, 4, T, 128), rnd(1, 28, T, 128)
        name = f"train_T{T}" if packed else f"dense_causal_T{T}"
        live = fa.live_tile_pairs(T, T, causal=True, segment_ids=seg)
        live_cpu = fa.live_tile_pairs(T, T, causal=True,
                                      segment_ids=None if seg is None else seg.cpu())
        if live != live_cpu:
            raise AssertionError(f"{name}: {live} live tiles on the GPU, {live_cpu} on the CPU")
        fwd_live, fwd_causal = k1_tiles(q, k, seg, True)
        row = {"shape": name, "q": list(q.shape), "kv_heads": 4, "causal": True,
               "segments": int(seg.unique().numel()) if packed else 1,
               "live_tiles": live, "causal_tiles": fa.live_tile_pairs(T, T, causal=True),
               "fwd_live_tiles": fwd_live, "fwd_causal_tiles": fwd_causal}
        o, lse, err, lse_err = check_k1(name, q, k, v, seg, True)
        errs["fwd"].append(err)
        row.update(fwd_err=err, fwd_lse_err=lse_err)
        e_dkv, e_dq = check_bwd(name, q, k, v, seg, True, o, lse, do)
        errs["dkv"].append(e_dkv)
        errs["dq"].append(e_dq)
        row.update(dkv_err=e_dkv, dq_err=e_dq)
        di = (o.float() * do.float()).sum(-1)
        pairs = valid_pairs((seg if packed else torch.zeros((1, T))).cpu(), True)
        # the kernels' own time: tile tables made once, as FlashAttentionFn does
        tabs = fa.segment_tile_tables(seg)
        row.update(
            fwd_ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True, segment_ids=seg,
                                                           tile_tables=tabs)),
            dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal=True,
                                                         segment_ids=seg, tile_tables=tabs)),
            dq_ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal=True,
                                                       segment_ids=seg, tile_tables=tabs)),
            plain_fwd_ms=cuda_ms(lambda: fa.mha_reference(q, k, v, causal=True,
                                                          segment_ids=seg), reps=5),
            plain_bwd_ms=cuda_ms(lambda: fa.flash_backward_reference(
                q, k, v, seg, seg, o, lse, do, True), reps=5),
            pairs_per_head=pairs)
        for kind in ("fwd", "dkv", "dq"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(kind, q, k, pairs)
        sdpa = _sdpa_args(q, k, v, seg, True)
        row["sdpa_fwd_ms"] = sdpa_fwd_ms(q, *sdpa)
        if T == TRAIN_LEN:
            row["bwd_ms"] = flash_backward_ms(q, k, v, seg, do)
            row["sdpa_bwd_ms"] = sdpa_bwd_ms(q, *sdpa, do)
        del sdpa
        train_rows.append(row)
        print("phase kernels: " + " ".join(
            f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items()) + f" gpu={gpu_line()!r}")
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return {"k1_serve": k1_rows, "train": train_rows, "errs": errs}


# ----------------------------------------------------------- int8 kernels
def _bytes_bound(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _row(kernel, shape, err, ms, plain_ms, bound, library_ms=None, extra=None, **launch):
    """A checked row of the kernels line: measured numbers, the bound and
    `extra` counts of the check. `launch` (the plan the wrapper hands the
    kernel) is printed on the phase line only."""
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **(extra or {})}
    print("phase kernels: " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in {**row, **launch}.items()) + f" gpu={gpu_line()!r}")
    return row


# K6a's rows: a decode token, the shared decode and its latent chunk, a
# realtime prompt and a batched cohort's prefill
K6A_ROWS = (1, BATCH_DECODE_M, BATCH_DECODE_M * N_QUERY, PROMPT_T, BATCH_ROWS * BATCH_PROMPT_T)


K6A_E, K6A_I = 3584, 18944  # the 7B hidden and intermediate widths


def k6a_row(device, g, kind, M, K, extra=None) -> dict:
    """K6a's prologue `kind` on M rows of width K against its plain
    version: "rmsnorm" and "rmsnorm_residual" (x + h bitwise, codes within
    +-1 and scales within 2^-7, the differing codes counted), "swiglu",
    "plain" (bf16 rows) and "plain_fp32" (the final norm's fp32 rows, the
    lm_head's input), the last three bitwise. The bound: each input read
    once (the norm scale too), the codes, scales and x + h written once.
    No single PyTorch call computes any of these functions, so there is no
    library time."""
    import torch

    from internnav_tpu_torch.ops import quant

    def rnd(dtype=torch.bfloat16):
        return (torch.randn((M, K), generator=g, device=device) * 3.0).to(dtype)

    if kind.startswith("rmsnorm"):
        x, w = rnd(), torch.randn(K, generator=g, device=device) * 0.3 + 1.0
        residual = rnd() if kind == "rmsnorm_residual" else None
        (q, s, xs), (rq, rs, rxs) = (quant.rmsnorm_quantize_cuda(x, w, 1e-6, residual),
                                     quant.rmsnorm_quantize_reference(x, w, 1e-6, residual))
        torch.cuda.synchronize()
        err = int((q.int() - rq.int()).abs().max())
        if not torch.equal(xs, rxs) or err > 1 \
                or not torch.allclose(s, rs, atol=0, rtol=2 ** -7):
            raise AssertionError(f"K6a {kind} M={M}: differs from the plain version (codes by "
                                 f"{err})")
        nbytes = M * K * (2 + 1) + 4 * K + 4 * M + (2 * 2 * M * K if residual is not None
                                                    else 0)
        return _row("K6a", f"{kind}_M{M}_K{K}", float(err),
                    cuda_ms(lambda: quant.rmsnorm_quantize_cuda(x, w, 1e-6, residual)),
                    cuda_ms(lambda: quant.rmsnorm_quantize_reference(x, w, 1e-6, residual)),
                    _bytes_bound(nbytes, 0, PEAK_INT8_OPS),
                    extra={"differing_codes": int((q != rq).sum()), "codes": M * K,
                           **(extra or {})})
    if kind == "swiglu":
        gate, up = rnd(), rnd()
        run, plain = (lambda: quant.swiglu_quantize_cuda(gate, up),
                      lambda: quant.swiglu_quantize_reference(gate, up))
        nbytes = M * K * (2 * 2 + 1)
    else:
        x = rnd(torch.float32 if kind == "plain_fp32" else torch.bfloat16)
        run, plain = lambda: quant.quantize_rows_cuda(x), lambda: quant.quantize_rows(x)
        nbytes = M * K * (x.element_size() + 1)
    (q, s), (rq, rs) = run(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(q, rq) and torch.equal(s, rs)):
        raise AssertionError(f"K6a {kind} M={M}: int8 codes or scales differ from the plain "
                             f"version ({int((q != rq).sum())} codes)")
    return _row("K6a", f"{kind}_M{M}_K{K}", 0.0, cuda_ms(run), cuda_ms(plain),
                _bytes_bound(nbytes + 4 * M, 0, PEAK_INT8_OPS),
                extra={"differing_codes": 0, "codes": M * K, **(extra or {})})


def int8_k6a_rows(device, g):
    """K6a's prologues at the 7B rows of K6A_ROWS (`k6a_row`): RMSNORM on
    the hidden width with and without the residual, SWIGLU on the
    intermediate width, PLAIN on the bf16 attention output and, at M = 1
    and the shared decode's rows (the lm_head's input), on fp32 rows."""
    rows = []
    for M in K6A_ROWS:
        for kind, K in (("rmsnorm", K6A_E), ("rmsnorm_residual", K6A_E), ("swiglu", K6A_I),
                        ("plain", K6A_E)):
            rows.append(k6a_row(device, g, kind, M, K))
        if M in (1, BATCH_DECODE_M):
            rows.append(k6a_row(device, g, "plain_fp32", M, K6A_E))
    return rows


# K6b's projections per decoder layer of the 7B model: (name, widths, K,
# bias); q/k/v and gate/up share an input and go to one launch at decode
GEMM_LAYER = (("qkv", (3584, 512, 512), 3584, True), ("o", (3584,), 3584, False),
              ("gate_up", (18944, 18944), 3584, False), ("down", (3584,), 18944, False))
GEMM_DECODE_ROWS = (1, 4, BATCH_ROWS)  # a token, the latent chunk, a cohort's decode
# the shared decode, its latent chunk, a realtime prompt, the long request's
# prompt, a batched cohort's prefill
GEMM_PREFILL_ROWS = (BATCH_DECODE_M, BATCH_DECODE_M * N_QUERY, PROMPT_T, LONG_PROMPT_T,
                     BATCH_ROWS * BATCH_PROMPT_T)
# the lm_head's rows: a token, a cohort's prefill (its last prompt tokens)
# or decode, the shared decode
GEMM_LM_HEAD_ROWS = (1, BATCH_ROWS, BATCH_DECODE_M)
GEMM_ODD_N = (63, 65, 4097)


def gemm_row(device, g, M, widths, K, bias, group=None, int_mm_refusal=None,
             extra=None) -> dict:
    """K6b on M rows of width K against one (per-channel or g=`group`)
    projection a width of `widths` (several: one fused launch, also held
    bitwise equal to their separate launches, whose summed time is
    `separate_ms`): per-channel bit for bit, grouped within GROUPED_TOL.
    Timed beside the plain version and the byte or operation bound; the
    decode tiles (M <= 16) also with a cold L2 (`cold_ms`), the prefill
    tiles beside torch._int_mm (an int32 product with no epilogue, not on
    the path; where it refuses, the reason goes to int_mm_refusal and the
    row has no library time). Outputs start uninitialised, so a tile the
    grid missed shows."""
    import torch

    from internnav_tpu_torch.ops import quant

    def weights(N):
        w = torch.randint(-127, 128, (N, K), generator=g, device=device, dtype=torch.int8)
        s = torch.rand((K // group, N) if group else (N,), generator=g, device=device) * 1e-3
        return w, s, (torch.randn(N, generator=g, device=device) if bias else None)

    xq, a = quant.quantize_rows(torch.randn((M, K), generator=g, device=device,
                                            dtype=torch.bfloat16))
    segs = [weights(N) for N in widths]
    run = (lambda: quant.w8a8_linear_multi(xq, a, segs))
    plain = (lambda: [quant.w8a8_linear_reference(xq, a, *sg) for sg in segs])
    ys, wants = run(), plain()
    torch.cuda.synchronize()
    err = max((y.float() - want.float()).abs().max().item() for y, want in zip(ys, wants))
    ok = all(torch.allclose(y.float(), want.float(), atol=GROUPED_TOL, rtol=GROUPED_TOL)
             if group else torch.equal(y, want) for y, want in zip(ys, wants))
    extra = dict(extra or {})
    if len(segs) > 1:  # the fused launch equals the separate ones
        alone = [quant.w8a8_linear_cuda(xq, a, *sg) for sg in segs]
        torch.cuda.synchronize()
        ok = ok and all(torch.equal(y, z) for y, z in zip(ys, alone))
        extra["separate_ms"] = cuda_ms(lambda: [quant.w8a8_linear_cuda(xq, a, *sg)
                                                for sg in segs])
    if not ok:
        raise AssertionError(f"K6b M={M} N={widths} K={K} group={group}: differs from the "
                             f"plain version (or the separate launches) by {err}")
    N = sum(widths)
    nbytes = (M * K + N * K + 4 * M + sum(4 * sg[1].numel() for sg in segs)
              + (4 * N if bias else 0) + 2 * M * N)
    launch, library_ms = {}, None
    if M <= quant.GEMM_DECODE_MAX_M:
        plan = quant.gemm_decode_plan(tuple(widths), K, group or 0, M)
        launch = {"split": plan.split, "grid": plan.grid, "stages": plan.stages}
        extra["cold_ms"] = cuda_ms(run, cold=True)
    del ys, wants
    if len(segs) == 1:  # torch._int_mm's time for the same int32 product
        wt = segs[0][0].t()
        try:
            torch._int_mm(xq, wt)
            library_ms = cuda_ms(lambda: torch._int_mm(xq, wt))
        except RuntimeError as e:
            if int_mm_refusal is not None:
                int_mm_refusal.setdefault(M, str(e).splitlines()[0])
    row = _row("K6b", f"M{M}_N{'+'.join(map(str, widths))}_K{K}" + (f"_g{group}" if group else ""),
               err, cuda_ms(run), cuda_ms(plain, reps=5),
               _bytes_bound(nbytes, 2.0 * M * N * K, PEAK_INT8_OPS), library_ms, extra=extra,
               **launch)
    del xq, a, segs
    torch.cuda.empty_cache()
    return row


def int8_gemm_rows(device, g):
    """K6b at the 7B shapes (`gemm_row`):
    - decode tiles (M in GEMM_DECODE_ROWS) for each projection of a layer,
      q/k/v and gate/up as one fused launch, warm and cold; the lm_head at
      GEMM_LM_HEAD_ROWS; grouped g=128 at M = 1;
    - prefill tiles (M in GEMM_PREFILL_ROWS) for each projection alone, as
      the prefill launches them, beside torch._int_mm; grouped g=128 at
      PROMPT_T;
    - odd N (GEMM_ODD_N) at M = 1, 4 (decode) and 17, 129 (prefill).
    torch._int_mm is tried at M <= 16 too; where it refuses, the reason is
    printed on a `phase kernels:` line."""
    int_mm_refusal = {}
    rows = []

    def check(M, widths, K, bias, group=None):
        rows.append(gemm_row(device, g, M, widths, K, bias, group, int_mm_refusal))

    for M in GEMM_DECODE_ROWS:
        for _, widths, K, bias in GEMM_LAYER:
            check(M, widths, K, bias)
    for M in GEMM_LM_HEAD_ROWS:
        check(M, (152064,), 3584, False)
    check(1, (18944,), 3584, False, group=128)
    prefill_shapes = {}  # (N, K): bias, for q (= o), k (= v), gate (= up), down
    for _, widths, K, bias in GEMM_LAYER:
        for N in widths:
            prefill_shapes.setdefault((N, K), bias)
    for M in GEMM_PREFILL_ROWS:
        for (N, K), bias in prefill_shapes.items():
            check(M, (N,), K, bias)
    check(PROMPT_T, (18944,), 3584, False, group=128)
    for M in (1, 4, 17, 129):
        for N in GEMM_ODD_N:
            check(M, (N,), 3584, True)
    for M, reason in sorted(int_mm_refusal.items()):
        print(f"phase kernels: K6b library torch._int_mm refuses M={M}: {reason}")
    return rows


# K9's and K10's rows. A layer's projections as the decode runs them (q/k/v
# and gate/up fused, `GEMM_LAYER`): K9 at a token, the latent chunk, a
# cohort's decode and the shared decode (its decode ring runs up to 64
# rows), K10 there and at the shared decode's latent chunk (its ring runs
# up to 192 rows); K9's prefill tiles take each projection alone
# (`QGEMM_LAYER`) at the shared decode's latent chunk, a realtime prompt
# and the long request's prompt
QGEMM_LAYER = (("q", 3584, 3584, True), ("k", 512, 3584, True), ("o", 3584, 3584, False),
               ("gate", 18944, 3584, False), ("down", 3584, 18944, False))
K9_DECODE_ROWS = (1, N_QUERY, BATCH_ROWS, BATCH_DECODE_M)
K9_PREFILL_ROWS = (BATCH_DECODE_M * N_QUERY, PROMPT_T, LONG_PROMPT_T)
K10_ROWS = (1, N_QUERY, BATCH_ROWS, BATCH_DECODE_M, BATCH_DECODE_M * N_QUERY)
#: rows a block of the plain versions' run (a grouped plain product holds a
#: (G, rows, N) float64 tensor)
PLAIN_ROW_BLOCK = 512
#: timings a K9/K10 row's median takes (each behind a ~5 ms device sleep):
#: half `cuda_ms`'s default, so that the rows added with the fused launches
#: cost the run no more time than the rows before them
QGEMM_REPS = 10


def qgemm_weights(g, device, N, K, bits, group, bias):
    """A random `bits`-bit projection of N outputs over K inputs: (int8
    codes (N, K), (the codes as the kernels take them (int4 packed),
    scales (N,) or (K / group, N) fp32, bias (N,) fp32 or None))."""
    import torch

    from internnav_tpu_torch.ops import quant

    qmax = quant.QMAX[bits]
    codes = torch.randint(-qmax, qmax + 1, (N, K), generator=g, device=device, dtype=torch.int8)
    s = torch.rand((K // group, N) if group else (N,), generator=g, device=device) * 1e-3
    b = torch.randn(N, generator=g, device=device) if bias else None
    return codes, (quant.pack_int4(codes) if bits == 4 else codes, s + 1e-4, b)


def qgemm_bytes(kernel, M, K, bits, segs) -> int:
    """The bytes a K9 ("K9": int8 rows and their fp32 scales) or K10 (bf16
    rows) launch over M rows must move, each once: the rows, the codes at
    bits / 8 bytes a weight, the scales and biases of `segs`, the bf16
    outputs."""
    N = sum(s.shape[-1] for _, s, _ in segs)
    rows = M * K + 4 * M if kernel == "K9" else 2 * M * K
    return (rows + N * K * bits // 8 + sum(4 * s.numel() for _, s, _ in segs)
            + sum(4 * b.numel() for _, _, b in segs if b is not None) + 2 * M * N)


def qgemm_row(device, g, kernel, M, widths, K, bias, bits, group, extra=None) -> dict:
    """K9 (`kernel` "K9": K6a's int8 rows times packed int4 codes) or K10
    ("K10": bf16 rows times int8 or packed int4 codes) on M rows of width K
    against one projection a width of `widths` (several: one fused launch,
    also held bitwise equal to their separate launches, whose summed time
    is `separate_ms`), against the plain version run in blocks of
    PLAIN_ROW_BLOCK rows: K9 per-channel bit for bit (exact integer sums,
    K6b's epilogue), K9 grouped and K10 within GROUPED_TOL (the sum over
    groups, and K10's fp32 sums, in other orders). Timed warm (medians of
    QGEMM_REPS), at M <= 16 also with a cold L2; the bound: each input read
    once (the codes at
    bits / 8 bytes a weight), the outputs written once, or the operations
    at the int8 (K9) or bf16 (K10) tensor-core peak. The library time, on
    the codes and scales of every projection stacked along N (one call
    for a fused launch's function): K10's is `w16_library`'s call where
    there is one (the reason is kept where there is none or it refuses);
    no PyTorch call takes K9's int8 rows with packed int4 codes, so K9 has
    none, and its grouped rows carry the int4 library call's time on the
    same rows in bf16 (`w4a16_library_ms`: the same weight stream)."""
    import torch

    from internnav_tpu_torch.ops import quant

    made = [qgemm_weights(g, device, N, K, bits, group, bias) for N in widths]
    segs = [seg for _, seg in made]
    x = torch.randn((M, K), generator=g, device=device, dtype=torch.bfloat16)
    if kernel == "K9":
        xq, a = quant.quantize_rows(x)
        run = (lambda: quant.w4a8_linear_multi(xq, a, segs))
        alone = (lambda: [quant.w4a8_linear_multi(xq, a, [sg])[0] for sg in segs])
        one = (lambda r, sg: quant.w4a8_linear_reference(xq[r], a[r], *sg))
        peak = PEAK_INT8_OPS
    else:
        run = (lambda: quant.w8a16_linear_multi(x, segs))
        alone = (lambda: [quant.w8a16_linear_multi(x, [sg])[0] for sg in segs])
        one = (lambda r, sg: quant.w8a16_linear_reference(x[r], *sg))
        peak = PEAK_BF16_FLOPS

    def plain():
        return [torch.cat([one(slice(i, i + PLAIN_ROW_BLOCK), sg)
                           for i in range(0, M, PLAIN_ROW_BLOCK)]) for sg in segs]

    ys, wants = run(), plain()
    torch.cuda.synchronize()
    err = max((y.float() - want.float()).abs().max().item() for y, want in zip(ys, wants))
    ok = all(torch.equal(y, want) if kernel == "K9" and not group
             else torch.allclose(y.float(), want.float(), atol=GROUPED_TOL, rtol=GROUPED_TOL)
             for y, want in zip(ys, wants))
    extra = {"bits": bits, **(extra or {})}
    if len(segs) > 1:  # the fused launch equals the separate ones
        ok = ok and all(torch.equal(y, z) for y, z in zip(ys, alone()))
        extra["separate_ms"] = cuda_ms(alone, reps=QGEMM_REPS)
    if not ok:
        raise AssertionError(f"{kernel} M={M} N={widths} K={K} bits={bits} group={group}: "
                             f"differs from the plain version (or the separate launches) "
                             f"by {err}")
    del ys
    library_ms = None
    if kernel == "K10" or group:
        # one call on the projections' codes and scales stacked along N:
        # the same function as the fused launch
        codes = torch.cat([c for c, _ in made])
        s = torch.cat([sg[1] for sg in segs], dim=-1)
        b = torch.cat([sg[2] for sg in segs]) if bias else None
        call, why = w16_library(x, codes, s, bits, group)
        if call is not None:
            try:
                got = call().float()
            except RuntimeError as e:  # the library's own limits
                call, why = None, f"refuses: {str(e).splitlines()[0]}"
        if call is None:
            extra["library"] = why
        else:
            want = torch.cat([w.float() for w in wants], dim=1)
            lib_err = (got + (b if bias else 0.0) - want).abs().max().item()
            if not lib_err <= LIBRARY_TOL * want.abs().max().item():
                raise AssertionError(f"{kernel} M={M} N={widths} bits={bits} group={group}: "
                                     f"the library call differs from the plain version by "
                                     f"{lib_err}")
            extra["library_max_abs_err"] = lib_err
            lib_ms = cuda_ms(call, reps=QGEMM_REPS)
            if kernel == "K10":
                library_ms = lib_ms
            else:
                extra["w4a16_library_ms"] = lib_ms
            del got, want
        del codes
    del wants
    N = sum(widths)
    nbytes = qgemm_bytes(kernel, M, K, bits, segs)
    launch = {}
    geometry = quant.K9_GEOMETRY if kernel == "K9" else quant.K10_GEOMETRY[bits]
    if M <= geometry.max_rows:  # the decode ring's launch
        plan = quant.gemm_decode_plan(tuple(widths), K, group or 0, M, geometry)
        launch = {"split": plan.split, "grid": plan.grid, "stages": plan.stages}
    if M <= quant.GEMM_DECODE_MAX_M:  # the decode rows, whose weights come cold
        extra["cold_ms"] = cuda_ms(run, reps=QGEMM_REPS, cold=True)
    shape = (f"M{M}_N{'+'.join(map(str, widths))}_K{K}" + (f"_g{group}" if group else "")
             + f"_int{bits}")
    row = _row(kernel, shape, err, cuda_ms(run, reps=QGEMM_REPS), cuda_ms(plain, reps=3),
               _bytes_bound(nbytes, 2.0 * M * N * K, peak), library_ms, extra=extra, **launch)
    torch.cuda.empty_cache()
    return row


def ring_bits_check(device, g) -> None:
    """K9 and K10 (int8 and int4 codes, per channel and grouped-128) on a
    7B layer's q/k/v: row r of a launch of M rows, for M in RING_BITS_ROWS
    (K9 above 64 rows on its prefill tiles), equals row r of the
    192-row launch bit for bit; up to 64 rows each projection alone, and
    the fused launch under a whole-K plan and a K split of 7, equal it
    too. Prints one `phase kernels:` line; raises where a bit differs."""
    import dataclasses

    import torch

    from internnav_tpu_torch.ops import quant

    K, widths = 3584, (3584, 512, 512)
    planner = quant.gemm_decode_plan

    def forced(split):
        def plan(segments, K, group, rows, geometry):
            p = dataclasses.replace(planner(segments, K, group, rows, geometry), split=split)
            most = max(l1 - l0 for l0, l1 in map(p.slice_lines, range(split)))
            p = dataclasses.replace(p, stages=min(geometry.max_stages, most))
            while p.stages > 1 and p.smem_bytes(rows) > quant.GEMM_BLOCK_SMEM:
                p = dataclasses.replace(p, stages=p.stages - 1)
            if p.smem_bytes(rows) > quant.GEMM_BLOCK_SMEM:  # too many partials: as planned
                return planner(segments, K, group, rows, geometry)
            return dataclasses.replace(p, grid=p.tiles * split if split > 1 else
                                       min(p.tiles, p.resident_blocks(rows)))
        return plan

    checked = 0
    for kernel, bits in (("K9", 4), ("K10", 8), ("K10", 4)):
        for group in (None, 128):
            segs = [qgemm_weights(g, device, N, K, bits, group, True)[1] for N in widths]
            x = torch.randn((max(RING_BITS_ROWS), K), generator=g, device=device,
                            dtype=torch.bfloat16)
            if kernel == "K9":
                xq, a = quant.quantize_rows(x)
                multi = (lambda M, sg: quant.w4a8_linear_multi(xq[:M], a[:M], sg))
            else:
                multi = (lambda M, sg: quant.w8a16_linear_multi(x[:M], sg))
            ref = multi(max(RING_BITS_ROWS), segs)
            for M in RING_BITS_ROWS:
                outs = [multi(M, segs)]
                if M <= quant.GEMM_SPLIT_MAX_M:
                    outs.append([multi(M, [sg])[0] for sg in segs])
                    for split in (1, 7):
                        quant.gemm_decode_plan = forced(split)
                        try:
                            outs.append(multi(M, segs))
                        finally:
                            quant.gemm_decode_plan = planner
                for ys in outs:
                    for y, r in zip(ys, ref):
                        if not torch.equal(y, r[:M]):
                            raise AssertionError(
                                f"{kernel} int{bits} group={group} M={M}: a row's bits depend on "
                                f"M, the plan or the fusion (max diff "
                                f"{(y.float() - r[:M].float()).abs().max().item()})")
                    checked += 1
    print(f"phase kernels: K9/K10 rows bitwise equal across M={list(RING_BITS_ROWS)}, whole-K "
          f"and split-7 plans, fused and separate launches ({checked} launches checked)")


#: the rows `ring_bits_check` holds row for row against the 192-row launch
RING_BITS_ROWS = (1, 4, 12, 16, 17, 48, 64, 65, 192)


#: how far a library call's product may sit from the plain version, over
#: the plain output's largest magnitude: the calls take bf16 scales, the
#: int4 one rounds each code times its scale to bf16, and against K9 they
#: take the rows unquantized, each a rounding of about 2^-8 of an entry;
#: a packing or layout mistake gives errors of the outputs' own size
LIBRARY_TOL = 2.0 ** -5


def w16_library(x, codes, s, bits, group):
    """(call, None): the one PyTorch call that computes K10's function
    (bf16 rows x times int8 or int4 codes (N, K) with their fp32 scales s)
    on the same inputs; (None, reason) where there is none. Per-channel
    int8: `torch._weight_int8pack_mm` (the scales in bf16). Grouped int4
    at 32-256: `torch._weight_int4pack_mm` (tinygemm), the codes packed
    once by `_convert_weight_to_int4pack` as it takes them (code + 8 in
    [1, 15], the even k in the high nibble; scales and zero points 0 as
    (G, N, 2) bf16; 8 inner k-tiles; N a multiple of 8). Timed only: the
    port never calls either, and keeps its own packing."""
    import torch

    if bits == 8 and not group:
        sb = s.to(torch.bfloat16)
        return (lambda: torch._weight_int8pack_mm(x, codes, sb)), None
    if bits == 4 and group in (32, 64, 128, 256):
        if codes.shape[0] % 8:  # asked only where its packing's checks allow
            return None, f"refuses: tinygemm packs N in multiples of 8, N={codes.shape[0]}"
        u = (codes.to(torch.int16) + 8).to(torch.uint8)
        packed = torch._convert_weight_to_int4pack((u[:, 0::2] << 4) | u[:, 1::2], 8)
        sz = torch.stack([s, torch.zeros_like(s)], -1).to(torch.bfloat16).contiguous()
        return (lambda: torch._weight_int4pack_mm(x, packed, group, sz)), None
    return None, (f"none: no PyTorch call takes {bits}-bit codes with "
                  f"{'grouped-' + str(group) if group else 'per-channel'} scales")


def int4_gemm_rows(device, g):
    """K9 and K10 at the 7B shapes (`qgemm_row`): K9's decode ring for each
    projection group of a layer (`GEMM_LAYER`: q/k/v and gate/up fused) at
    K9_DECODE_ROWS, its prefill tiles for each projection alone at
    K9_PREFILL_ROWS (grouped-128 int4), the gate alone at M = 1 (beside the
    int4 library call), per channel at M = 1 and PROMPT_T, odd N
    (GEMM_ODD_N) at M = 1 (the ring) and 129 (the prefill tiles); K10 for
    each projection group at K10_ROWS with per-channel int8 codes (W8A16
    over the int8 realtime weights) and grouped-128 int4 codes (W4A16), the
    gate alone at M = 1 in all four layouts (beside the library calls where
    they exist), and the lm_head at GEMM_LM_HEAD_ROWS per-channel int8 and
    8-bit grouped-128 (the int4 format's lm_head); then `ring_bits_check`."""
    rows = []
    for M in K9_DECODE_ROWS:
        for _, widths, K, bias in GEMM_LAYER:
            rows.append(qgemm_row(device, g, "K9", M, widths, K, bias, 4, 128))
    for M in K9_PREFILL_ROWS:
        for _, N, K, bias in QGEMM_LAYER:
            rows.append(qgemm_row(device, g, "K9", M, (N,), K, bias, 4, 128))
    rows.append(qgemm_row(device, g, "K9", 1, (18944,), 3584, False, 4, 128))
    for M in (1, PROMPT_T):
        rows.append(qgemm_row(device, g, "K9", M, (18944,), 3584, False, 4, None))
    for M in (1, 129):
        for N in GEMM_ODD_N:
            rows.append(qgemm_row(device, g, "K9", M, (N,), 3584, True, 4, 128))
    for M in K10_ROWS:
        for _, widths, K, bias in GEMM_LAYER:
            rows.append(qgemm_row(device, g, "K10", M, widths, K, bias, 8, None))
            rows.append(qgemm_row(device, g, "K10", M, widths, K, bias, 4, 128))
    for bits, group in ((8, None), (4, 128), (8, 128), (4, None)):
        rows.append(qgemm_row(device, g, "K10", 1, (18944,), 3584, False, bits, group))
    for M in GEMM_LM_HEAD_ROWS:
        rows.append(qgemm_row(device, g, "K10", M, (152064,), 3584, False, 8, None))
        rows.append(qgemm_row(device, g, "K10", M, (152064,), 3584, False, 8, 128))
    ring_bits_check(device, g)
    return rows


def int8_cache(device, g, Tmax, B=1):
    """(k, v) int8 cache entries (B, Tmax, 4 KV heads, D=128) of random
    codes and scales."""
    import torch

    def entry():
        return (torch.randint(-127, 128, (B, Tmax, 4, 128), generator=g, device=device,
                              dtype=torch.int8),
                torch.rand((B, Tmax, 4, 1), generator=g, device=device) * 0.05 + 1e-3)

    return entry(), entry()


def _decode_cases():
    """(kernel, Tmax, cache_len per row, n) of K4/K5's checked rows: the
    realtime caches of the first, the fourth and the long request (Tmax =
    prompt + 128 + 4) late in the decode; a ragged batch of 3; n = 8 (56
    query rows a KV head, two row tiles); a batched cohort's group (12
    rows, BATCH_TMAX slots) at the last decode step and at the latent
    chunk."""
    cases = []
    for T in (352, PROMPT_T, LONG_PROMPT_T):
        Tmax = T + MAX_NEW_TOKENS + N_QUERY
        cases += [("K4", Tmax, (Tmax - N_QUERY - 1,), 1), ("K5", Tmax, (Tmax - N_QUERY,), N_QUERY)]
    Tmax = PROMPT_T + MAX_NEW_TOKENS + N_QUERY
    cases += [("K4", Tmax, (PROMPT_T + 17, 17, 700), 1), ("K5", Tmax, (Tmax - 8,), 8)]
    end = BATCH_PROMPT + BATCH_NEW_TOKENS
    cases += [("K4", BATCH_TMAX, (end - 1,) * BATCH_ROWS, 1),
              ("K5", BATCH_TMAX, (end,) * BATCH_ROWS, N_QUERY)]
    return cases


def _lengths(values) -> str:
    """Per-row values joined by _, or "vxB" for B rows of one value."""
    values = list(values)
    if len(values) > 1 and len(set(values)) == 1:
        return f"{values[0]}x{len(values)}"
    return "_".join(map(str, values))


def decode_shape(Tmax, lengths, n) -> str:
    keys = _lengths(min(Tmax, x + n) for x in lengths)  # keys each row's last query sees
    return f"B{len(lengths)}_Tmax{Tmax}_keys{keys}_n{n}"


def decode_row(device, g, kernel, Tmax, lengths, n, extra=None) -> dict:
    """K4 (n = 1) or K5 (n > 1) over a random int8 cache of len(lengths)
    rows and Tmax slots, row b's new queries at positions lengths[b] on,
    against the plain version (within DECODE_TOL). The bound: the keys
    each (batch, KV head) must read (K, V and their scales), q in and out
    once; the score and P.V flops of the live pairs at the bf16
    tensor-core peak (both products run as bf16 mma.sync)."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    B = len(lengths)
    ke, ve = int8_cache(device, g, Tmax, B)
    views = (ke[0].transpose(1, 2), ve[0].transpose(1, 2))
    sc = dict(k_scale=ke[1][..., 0].transpose(1, 2), v_scale=ve[1][..., 0].transpose(1, 2))
    cache_len = torch.tensor(lengths, device=device)
    if n == 1:
        q = torch.randn((B, 28, 128), generator=g, device=device, dtype=torch.bfloat16)
        lens = cache_len + 1

        def run():
            return fa.gqa_decode_int8_cuda(q, *views, lens, **sc)

        def plain():
            return fa.gqa_decode_reference(q, *views, lens, **sc)
    else:
        q = torch.randn((B, 28, n, 128), generator=g, device=device, dtype=torch.bfloat16)

        def run():
            return fa.gqa_chunk_decode_int8_cuda(q, *views, cache_len, **sc)

        def plain():
            return fa.gqa_chunk_decode_reference(q, *views, cache_len, **sc)
    out, want = run(), plain()
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if not torch.allclose(out.float(), want.float(), atol=DECODE_TOL, rtol=DECODE_TOL):
        raise AssertionError(f"{kernel} B={B} Tmax={Tmax} n={n}: differs from the plain "
                             f"version by {err}")
    live = fa.decode_live_keys(lengths, 0 if n == 1 else 1, n, Tmax)
    nbytes = 2 * 4 * sum(live) * (128 + 4) + 2 * 2 * B * 28 * n * 128 + 8 * B
    pairs = sum(28 * min(Tmax, x + 1 + i) for x in lengths for i in range(n))
    return _row(kernel, decode_shape(Tmax, lengths, n), err, cuda_ms(run), cuda_ms(plain),
                _bytes_bound(nbytes, 4.0 * pairs * 128, PEAK_BF16_FLOPS), extra=extra,
                cluster=fa.decode_cluster_size(Tmax))


def int8_decode_rows(device, g):
    """K4 (n = 1) and K5 (n > 1) at `_decode_cases` (`decode_row`)."""
    return [decode_row(device, g, kernel, Tmax, lengths, n)
            for kernel, Tmax, lengths, n in _decode_cases()]


def kv_write_shape(rotary: bool, lengths, n) -> str:
    return f"{'rotary' if rotary else 'no_rotary'}_B{len(lengths)}_n{n}_pos{_lengths(lengths)}"


def kv_write_row(device, g, rotary, n, lengths, Tmax, extra=None) -> dict:
    """K7 on len(lengths) rows of n new tokens at positions lengths into a
    random int8 cache of Tmax slots, with rotary (`rope_kv_write_cuda`) or
    without (`write_kv_cache_cuda`, the prompt's entries): the rotated q,
    the codes and the scales bitwise against the plain version. The
    bound: q, k, v and cos/sin read once; q rotated, the codes and scales
    written once."""
    import torch

    from internnav_tpu_torch.ops import quant
    from internnav_tpu_torch.ops.rope import mrope_cos_sin

    H, KV, D = 28, 4, 128
    B = len(lengths)

    def rnd(width):
        return torch.randn((B * n, width), generator=g, device=device, dtype=torch.bfloat16)

    q, k, v = rnd(H * D), rnd(KV * D), rnd(KV * D)
    pos = torch.randint(0, Tmax, (3, B, n), generator=g, device=device)
    cos, sin = mrope_cos_sin(pos, D, (16, 24, 24))
    cache_len = torch.tensor(lengths, device=device)
    ke, ve = int8_cache(device, g, Tmax, B)
    ref = [tuple(t.clone() for t in e) for e in (ke, ve)]
    if rotary:
        def run():
            return quant.rope_kv_write_cuda(q, k, v, cos, sin, ke, ve, cache_len)

        def plain():
            return quant.rope_kv_write_reference(q, k, v, cos, sin, ke, ve, cache_len)
    else:
        kb, vb = k.view(B, n, KV, D), v.view(B, n, KV, D)

        def run():
            return quant.write_kv_cache_cuda(kb, vb, ke, ve, cache_len)

        def plain():
            return quant.write_kv_cache_reference(kb, vb, ke, ve, cache_len)
    got = run()
    want = (quant.rope_kv_write_reference(q, k, v, cos, sin, *ref, cache_len) if rotary
            else quant.write_kv_cache_reference(kb, vb, *ref, cache_len))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((*ke, *ve), (*ref[0], *ref[1]))) \
            or (rotary and not torch.equal(got, want)):
        raise AssertionError(f"K7 rotary={rotary} n={n} lengths={lengths}: the rotated q or "
                             "the cache differs from the plain version's")
    kv_elems = B * n * KV * D
    nbytes = 2 * 2 * kv_elems + 2 * kv_elems + 2 * 4 * B * n * KV + 8 * B
    if rotary:  # q in and out, cos and sin in
        nbytes += 2 * 2 * B * n * H * D + 2 * 4 * B * n * D
    return _row("K7", kv_write_shape(rotary, lengths, n), 0.0, cuda_ms(run), cuda_ms(plain),
                _bytes_bound(nbytes, 0, PEAK_INT8_OPS), extra=extra)


def int8_kv_write_rows(device, g):
    """K7 (`kv_write_row`) with rotary for one decode token, the latent
    chunk, a chunk that runs past the cache's end (the start clamped, as
    the JAX package's dynamic_update_slice does) and a ragged batch of 3
    whose row past the end is dropped; without rotary for the prompt's
    entries (at 0); a batched cohort's 12 rows at the last decode token,
    the latent chunk and the prompt (BATCH_TMAX slots)."""
    tmax = PROMPT_T + MAX_NEW_TOKENS + N_QUERY
    end = BATCH_PROMPT + BATCH_NEW_TOKENS
    return [kv_write_row(device, g, rotary, n, lengths, Tmax)
            for rotary, n, lengths, Tmax in (
                (True, 1, (PROMPT_T + 17,), tmax),
                (True, N_QUERY, (PROMPT_T + MAX_NEW_TOKENS,), tmax),
                (True, N_QUERY, (tmax - 1,), tmax),
                (True, 1, (PROMPT_T + 17, 17, tmax), tmax),
                (False, PROMPT_T, (0,), tmax),
                (True, 1, (end - 1,) * BATCH_ROWS, BATCH_TMAX),
                (True, N_QUERY, (end,) * BATCH_ROWS, BATCH_TMAX),
                (False, BATCH_PROMPT_T, (0,) * BATCH_ROWS, BATCH_TMAX))]


#: K8's rows (kind, M, K, offset): a parity decode token's, a parity
#: prompt's and the train row's SwiGLU, a 420x420 frame's vision MLP, a
#: stream's 32 NextDiT samples' feed-forward and the time embedding's
#: SiLU; then a length that is no multiple of 8 (the vector loop and its
#: tail) and inputs 3 elements into their buffers (no pointer 16-byte
#: aligned: the element loop)
K8_ROWS = (("silu_mul", 1, K6A_I, 0), ("silu_mul", PROMPT_T, K6A_I, 0),
           ("silu_mul", 8192, K6A_I, 0), ("silu_mul", 900, 3420, 0),
           ("silu_mul", 1024, 1024, 0), ("silu", 1, 384, 0), ("silu_mul", 3, 1001, 0),
           ("silu_mul", 7, 1280, 3), ("silu", 7, 1280, 3))
#: fp32 operations K8 takes an element (flush test, exp, add, division,
#: threshold, product with the gate, product with up, four roundings)
K8_OPS = 12


def k8_row(device, g, kind, M, K, offset=0, extra=None) -> dict:
    """K8 (`activations.silu_cuda`) on M x K bf16 inputs that start
    `offset` elements into their buffers, against its plain version
    (`silu_mul_reference` / `silu_reference`), bitwise. The bound: the
    inputs read once and the output written once, or K8_OPS fp32
    operations an element. No single PyTorch call computes it."""
    import torch

    from internnav_tpu_torch.ops import activations as act

    def rnd(scale):
        buf = (torch.randn(M * K + offset, generator=g, device=device) * scale).bfloat16()
        return buf[offset:].view(M, K)

    gate = rnd(3.0)
    up = rnd(1.0) if kind == "silu_mul" else None
    run = lambda: act.silu_cuda(gate, up)  # noqa: E731
    plain = (lambda: act.silu_mul_reference(gate, up)) if up is not None \
        else (lambda: act.silu_reference(gate))
    out, ref = run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(f"K8 {kind} M={M} K={K}: differs from the plain version in "
                             f"{int((out.view(torch.int16) != ref.view(torch.int16)).sum())} "
                             "elements")
    n = M * K
    return _row("K8", f"{kind}_M{M}_K{K}" + (f"_offset{offset}" if offset else ""), 0.0,
                cuda_ms(run), cuda_ms(plain),
                _bytes_bound(n * 2 * (3 if up is not None else 2), K8_OPS * n, PEAK_FP32_FLOPS),
                extra=extra)


def phase_int8_kernels(device) -> dict:
    """The realtime profile's kernels at the 7B shapes, K8 at the bf16
    paths' SiLU shapes, and the int4 / W8A16 GEMMs K9 and K10; rows by
    kernel."""
    import torch

    g = torch.Generator(device=device).manual_seed(2)
    rows = (int8_k6a_rows(device, g) + int8_gemm_rows(device, g)
            + int8_decode_rows(device, g) + int8_kv_write_rows(device, g)
            + [k8_row(device, g, *shape) for shape in K8_ROWS] + int4_gemm_rows(device, g))
    return {name: [r for r in rows if r["kernel"] == name]
            for name in ("K4", "K5", "K6a", "K6b", "K7", "K8", "K9", "K10")}


# ----------------------------------------------------------------- serve
def _post(port: int, route: str, body: dict):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request_frames(rng):
    """One seeded 420x420 camera frame: uint8 rgb (H, W, 3), depth (H, W, 1)."""
    import numpy as np

    return (rng.integers(0, 256, (420, 420, 3)).astype(np.uint8),
            rng.uniform(0.0, 0.5, (420, 420, 1)).astype(np.float32))


def build_agent(device, profile: str = "parity", policy=None):
    """The full-width 7B policy of a serving profile (random weights, seed
    0, unless `policy` is given) and its agent, synchronous and re-planning
    System-2 after every action."""
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
    from internnav_tpu_torch.realworld import serve

    if policy is None:
        policy = serve.build_policy(profile, device=device)
    return policy, InternVLAN1Agent.with_policy(policy, async_s2=False, sys2_max_forward_step=1)


LAUNCH_KEYS = ("K1", "K2", "K3", "K4", "K5", "K6a", "K6a_rmsnorm", "K6a_swiglu", "K6a_plain",
               "K6b", "K6b_fused", "K7", "K9", "K9_fused", "K10", "K10_fused")


def launch_counts() -> dict:
    """Every kernel's launch count, by name: LAUNCH_KEYS and K8."""
    from internnav_tpu_torch.ops import activations as act
    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.ops import quant

    return {"K8": act.silu_launches,
            "K1": fa.kernel_launches, "K2": fa.bwd_dkv_launches, "K3": fa.bwd_dq_launches,
            "K4": fa.decode_int8_launches, "K5": fa.chunk_decode_int8_launches,
            "K6a": quant.quantize_rows_launches, "K6a_rmsnorm": quant.rmsnorm_quantize_launches,
            "K6a_swiglu": quant.swiglu_quantize_launches,
            "K6a_plain": quant.plain_quantize_launches, "K6b": quant.w8a8_launches,
            "K6b_fused": quant.w8a8_fused_launches, "K7": quant.kv_write_launches,
            "K9": quant.w4a8_launches, "K9_fused": quant.w4a8_fused_launches,
            "K10": quant.w8a16_launches, "K10_fused": quant.w8a16_fused_launches}


def reset_launch_counts() -> None:
    from internnav_tpu_torch.ops import activations as act
    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.ops import quant

    act.silu_launches = 0
    fa.kernel_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.decode_int8_launches = fa.chunk_decode_int8_launches = 0
    quant.quantize_rows_launches = quant.w8a8_launches = quant.kv_write_launches = 0
    quant.rmsnorm_quantize_launches = quant.swiglu_quantize_launches = 0
    quant.plain_quantize_launches = quant.w8a8_fused_launches = 0
    quant.w4a8_launches = quant.w8a16_launches = 0
    quant.w4a8_fused_launches = quant.w8a16_fused_launches = 0


def _count_calls(obj, names, calls):
    """Wrap obj's methods `names` so that each call adds one to calls[name]."""
    for name in names:
        fn = getattr(obj, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        setattr(obj, name, wrapper)


def expected_serve_launches(cfg, profile, steps, logits_calls, s1_calls,
                            dit_layers) -> dict:
    """Launches of len(steps) requests, request r with one prefill,
    steps[r] decode steps run on the device (graph replays and the warm-up
    step of each capture) and one traj-latent chunk, `logits_calls`
    lm_head calls and `s1_calls` System-1 denoises over NextDiT's
    `dit_layers` in all: K1 once per prefill layer and once per windowed
    ViT block of the request's new frame; K8 once per ViT block of that
    frame, per parity decoder layer pass (the SwiGLU), and per System-1
    velocity 2 per NextDiT layer and 2 more (the time embedding's and the
    output norm's SiLU); with the realtime profile per layer pass 4
    activation quantizations (K6a: the two RMSNorms, q/k/v
    sharing the first and gate/up the second; the SwiGLU product for down;
    o_proj's input as it is) and one K7 launch (rotary + K/V cache write;
    the prefill's without rotary); K6b 4 launches per decode or chunk layer
    pass (q/k/v fused, o, gate/up fused, down: 2 of them fused, K6b_fused)
    and 7 per prefill layer pass (each projection alone on the prefill
    tiles); plus one plain K6a and one K6b per lm_head call; K4 per decode
    layer, K5 per chunk layer. With int4 weights K9 takes the layers'
    projections as K6b takes them at 8 bits (4 launches a decode or chunk
    layer pass, 2 fused, K9_fused; 7 a prefill layer pass) and K6b only the
    lm_head (8 bits). With decode_act_dtype="bf16" every decode or chunk
    layer pass runs its projections on K10 (4 launches, 2 fused,
    K10_fused), its SwiGLU on K8 and no K6a, and so does each decode
    step's lm_head call (K10); the prefills stay as above."""
    L = cfg.text.num_hidden_layers
    text = cfg.text
    windowed = cfg.vision.depth - len(cfg.vision.fullatt_block_indexes)
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want["K1"] = len(steps) * (L + windowed)
    decode_passes = sum(1 + s for s in steps)  # decode steps + chunk, per layer
    passes = len(steps) + decode_passes  # and the prefill
    want["K8"] = (len(steps) * cfg.vision.depth + s1_calls * s1_silu_launches(cfg, dit_layers)
                  + (L * passes if profile == "parity" else 0))
    if profile == "realtime":
        n = len(steps)
        # layer passes and lm_head calls whose activations K6a quantizes
        act_passes, act_logits = (n, n) if text.decode_bf16_act else (passes, logits_calls)
        w8a8_passes = act_passes - n  # decode or chunk layer passes on W8A8 / W4A8
        want.update(K4=L * sum(steps), K5=L * n, K6a=4 * L * act_passes + act_logits,
                    K6a_rmsnorm=2 * L * act_passes, K6a_swiglu=L * act_passes,
                    K6a_plain=L * act_passes + act_logits, K7=L * passes)
        gemm = "K9" if text.weight_dtype == "int4" else "K6b"
        want[gemm] = 4 * L * w8a8_passes + 7 * L * n
        want[f"{gemm}_fused"] = 2 * L * w8a8_passes
        want["K6b"] += act_logits
        if text.decode_bf16_act:
            want.update(K10=4 * L * decode_passes + logits_calls - n,
                        K10_fused=2 * L * decode_passes)
            want["K8"] += L * decode_passes
    return want


#: the System-1 denoise's Euler steps (`generate_traj_nextdit`'s default)
S1_STEPS = 10


def s1_silu_launches(cfg, dit_layers: int) -> int:
    """K8 launches of one System-1 denoise: NextDiT's S1_STEPS velocities,
    2 a layer and 2 more (the time embedding's and the output norm's SiLU);
    none for the NavDP head (fp32 GELU and ReLU, no SiLU)."""
    return 0 if "navdp" in cfg.system1 else S1_STEPS * (2 * dit_layers + 2)


def dit_layers(policy) -> int:
    """NextDiT's layers (0 for a NavDP System-1)."""
    dit = getattr(policy.model, "traj_dit", None)
    return 0 if dit is None else len(dit.layers)


def loop_steps(generated: int) -> int:
    """Decode steps the loop replays for a request that generated
    `generated` tokens: it runs in chunks of DECODE_CHUNK steps, and stops
    after the chunk in which the stop token was fed, or at the budget."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DECODE_CHUNK

    return min(MAX_NEW_TOKENS, -(-(generated + 1) // DECODE_CHUNK) * DECODE_CHUNK)


def decode_stats():
    from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph

    return collections.Counter(decode_graph.stats)


def long_request_frames(rng):
    """LONG_FRAMES seeded 644x644 camera frames: uint8 rgb, depth."""
    import numpy as np

    return [(rng.integers(0, 256, (LONG_HW, LONG_HW, 3)).astype(np.uint8),
             rng.uniform(0.0, 0.5, (LONG_HW, LONG_HW, 1)).astype(np.float32))
            for _ in range(LONG_FRAMES)]


def _eval_dual(port, policy, rgb, depth) -> float:
    """One /eval_dual request; its latency, after checking for HTTP 200 and
    a finite trajectory of the right shape."""
    import numpy as np

    from internnav_tpu_torch.realworld import serve

    body = {"instruction": INSTRUCTION, "rgb": serve.encode_npy(rgb),
            "depth": serve.encode_npy(depth)}
    t = time.perf_counter()
    code, resp = _post(port, "/eval_dual", body)
    latency = time.perf_counter() - t
    traj = np.asarray(resp.get("trajectory", []), np.float64)
    if code != 200 or traj.shape != (policy.cfg.predict_step_nums, 3) \
            or not np.isfinite(traj).all():
        raise AssertionError(f"/eval_dual gave {code} with trajectory shape {traj.shape}")
    return latency


def _check_requests(policy, profile, what, calls, chunks, gen_tokens, loop, launches):
    """The requests' System-2 steps and latent chunks, their decode loops
    (`loop`: per request the decode_graph stats it added) and every
    kernel's launches, held to `expected_serve_launches`. Returns the
    device decode steps of each request."""
    n = len(gen_tokens)
    if calls["s2_step"] != n or calls["s1_step_latent"] < 1 or chunks != n:
        raise AssertionError(f"{what}: main path calls {calls}, {chunks} latent chunks: want "
                             f"{n} System-2 ({n} chunks) and >= 1 System-1")
    for t, st in zip(gen_tokens, loop):
        # every step on the card is a graph replay, besides the one warm-up
        # step of each new loop (whose two graphs are captured)
        want_logits = loop_steps(t) - (loop_steps(t) == MAX_NEW_TOKENS) + st["warmup_steps"]
        if st["replays"] != loop_steps(t) or st["captures"] != 2 * st["warmup_steps"] \
                or st["steps"] != st["replays"] + st["warmup_steps"] \
                or st["logits_steps"] != want_logits:
            raise AssertionError(f"{what}: decode loop {dict(st)} does not follow the generated "
                                 f"length {t} (replays {loop_steps(t)} expected)")
    steps = [st["steps"] for st in loop]
    logits_calls = n + sum(st["logits_steps"] for st in loop)  # the prefills' and the steps'
    want = expected_serve_launches(policy.cfg, profile, steps, logits_calls,
                                   calls["s1_step_latent"], dit_layers(policy))
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")
    return steps


def phase_serve(device, profile: str, policy, build_s: float, *, label: str = "",
                requests: int = 4, long_request: bool = True,
                prompts: list = None) -> dict:
    """Serve `policy`, the 7B policy of `profile` (built or loaded in
    build_s), through the real-robot HTTP server; returns every kernel's
    launches by path (`label`, by default serve_<profile>): the `requests`
    requests, and with the realtime profile and `long_request` also the
    long request, each held equal to `expected_serve_launches`. With
    `prompts`, each request's System-2 inputs (`fused_s2`'s arguments) are
    appended to it."""
    import numpy as np
    import torch

    from internnav_tpu_torch.realworld import serve

    policy, agent = build_agent(device, profile, policy)
    build_mem_gib = torch.cuda.memory_allocated(device) / 2**30
    text = policy.cfg.text
    calls = {"s2_step": 0, "s1_step_latent": 0}
    _count_calls(policy, calls, calls)
    lm = policy.model.language_model
    lm_calls = {"decode_chunk_grouped": 0}
    _count_calls(lm, lm_calls, lm_calls)
    prompt_T = []  # each prefill's bucketed prompt length
    forward = lm.forward

    def recorded_forward(inputs_embeds, *args, **kwargs):
        prompt_T.append(inputs_embeds.shape[1])
        return forward(inputs_embeds, *args, **kwargs)

    lm.forward = recorded_forward
    if prompts is not None:
        fused_s2 = policy.fused_s2

        def recorded_fused_s2(*args):
            prompts.append(args[:-1])
            return fused_s2(*args)

        policy.fused_s2 = recorded_fused_s2
    port = _free_port()
    server = serve.RealWorldServer(agent, "127.0.0.1", port)
    thread = server.run(background=True)
    rng = np.random.default_rng(0)
    latencies, gen_tokens, loop = [], [], []
    by_path = {}
    long = {}
    label = label or f"serve_{profile}"
    try:
        if _post(port, "/reset", {}) != (200, {"status": "ok"}):
            raise AssertionError("/reset failed")
        torch.cuda.reset_peak_memory_stats(device)
        lm_calls["decode_chunk_grouped"] = 0
        reset_launch_counts()  # count only the requests' launches
        for _ in range(requests):
            before = decode_stats()
            latencies.append(_eval_dual(port, policy, *request_frames(rng)))
            gen_tokens.append(len(policy.last_gen_tokens))
            loop.append(decode_stats() - before)
        by_path[label] = launch_counts()
        steps = _check_requests(policy, profile, label, calls,
                                lm_calls["decode_chunk_grouped"], gen_tokens, loop,
                                by_path[label])
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        if profile == "realtime" and long_request:
            # the long request: a new episode whose first 8 frames are
            # stepped directly with a short decode budget (not counted),
            # then the ninth through the server with the full budget
            if _post(port, "/reset", {}) != (200, {"status": "ok"}):
                raise AssertionError("/reset failed")
            frames = long_request_frames(rng)
            t = time.perf_counter()
            for rgb, _ in frames[:-1]:
                policy.s2_step(rgb, INSTRUCTION, max_new_tokens=WARMUP_NEW_TOKENS)
            torch.cuda.synchronize()
            long["warmup_s"] = time.perf_counter() - t
            for d in (calls, lm_calls):
                for k in d:
                    d[k] = 0
            prompt_T.clear()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            before = decode_stats()
            long["request_s"] = _eval_dual(port, policy, *frames[-1])
            long["loop"] = decode_stats() - before
            by_path["serve_realtime_long"] = launch_counts()
            long["generated_tokens"] = len(policy.last_gen_tokens)
            long["prompt_T"] = prompt_T
            long["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            if prompt_T != [LONG_PROMPT_T]:
                raise AssertionError(f"the long request prefilled {prompt_T} tokens, expected "
                                     f"[{LONG_PROMPT_T}]")
            long["decode_steps"] = _check_requests(
                policy, profile, "the long realtime request", calls,
                lm_calls["decode_chunk_grouped"], [long["generated_tokens"]], [long["loop"]],
                by_path["serve_realtime_long"])[0]
    finally:
        server.shutdown()
        thread.join(timeout=30)
        agent.close()
        if prompts is not None:
            del policy.fused_s2
    # per decode step with its lm_head call
    one, none = (expected_serve_launches(policy.cfg, profile, [s], s + 1, 0, 0) for s in (1, 0))
    per_step = {k: one[k] - none[k] for k in one if one[k] != none[k]}
    print(f"phase serve: path={label} profile={profile} weight_dtype={text.weight_dtype} "
          f"decode_act_dtype={text.decode_act_dtype} "
          f"kv_dtype={text.kv_dtype} layers={text.num_hidden_layers} hidden={text.hidden_size} "
          f"build_s={build_s:.2f} resident_gib={build_mem_gib:.2f} "
          f"request_s={[round(x, 4) for x in latencies]} generated_tokens={gen_tokens} "
          f"decode_steps={steps} decode_loop={[dict(st) for st in loop]} "
          f"launches={by_path[label]} "
          f"launches_per_decode_step={per_step} "
          f"peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    if long:
        print(f"phase serve: profile=realtime long_request frames={LONG_FRAMES}x{LONG_HW}px "
              f"prompt_T={long['prompt_T']} cache_Tmax={LONG_PROMPT_T + MAX_NEW_TOKENS + N_QUERY} "
              f"http=200 warmup_s={long['warmup_s']:.2f} request_s={long['request_s']:.4f} "
              f"generated_tokens={long['generated_tokens']} decode_steps={long['decode_steps']} "
              f"decode_loop={dict(long['loop'])} "
              f"launches={by_path['serve_realtime_long']} peak_mem_gib={long['peak_mem_gib']:.2f} "
              f"gpu={gpu_line()!r}")
    return by_path


# -------------------------------------------------------------- serve tp
@contextlib.contextmanager
def one_rank_nccl(device):
    """A one-rank NCCL process group on this card (MASTER_ADDR and
    MASTER_PORT set where absent), destroyed on exit."""
    import socket

    import torch.distributed as dist

    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    if "MASTER_PORT" not in os.environ:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            os.environ["MASTER_PORT"] = str(sock.getsockname()[1])
    dist.init_process_group("nccl", rank=0, world_size=1, device_id=device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_serve_tp(device, policy, prompts) -> dict:
    """Multi-GPU serving at world size 1: serve parity's System-2 prompts
    (`prompts`, `fused_s2`'s inputs: the vision tokens, ids, positions,
    rope deltas, lengths and segments of each request) greedy-decoded with
    MAX_NEW_TOKENS by the parity policy as it is, then with its decoder
    laid out for serving (`parallel/tp.apply_serve_tp`) over the tp group
    of a dp=1 x tp=1 mesh of a one-rank NCCL group: every row-parallel
    projection's all-reduce, the vocab-split embedding's and the lm_head's
    argmax reduce are NCCL collectives, inside the captured decode step.
    The laid-out prompts run twice: a warm pass that captures the decode
    step's graphs with the collectives in them (serve parity captured the
    unsharded ones), then the counted pass, which replays them, as the
    unsharded pass does. Tokens, lengths and traj latents must be bitwise
    equal; K1 must launch once a prefill layer on the rank's local heads
    (the spy records each launch's query and KV heads). The policy keeps
    the layout (the phase is its last use). Returns the counted pass's
    launches."""
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
    from internnav_tpu_torch.parallel.mesh import make_mesh
    from internnav_tpu_torch.parallel.tp import apply_serve_tp

    def decode_all():
        outs, secs = [], []
        for args in prompts:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tokens, lengths, latents = policy.fused_s2(*args, MAX_NEW_TOKENS)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            outs.append((tokens.cpu(), lengths.cpu(), latents.float().cpu()))
        return outs, secs

    if len(prompts) != 4:
        raise AssertionError(f"serve tp: {len(prompts)} recorded prompts, expected 4")
    whole, whole_s = decode_all()
    lm = policy.model.language_model
    heads = collections.Counter()
    flash = qt.flash_attention

    def spy(q, k, *args, **kwargs):
        heads[(q.shape[1], k.shape[1])] += 1
        return flash(q, k, *args, **kwargs)

    with one_rank_nccl(device):
        mesh = make_mesh({"dp": 1, "tp": 1})
        layout = apply_serve_tp(lm, mesh.get_group("tp"))
        split = sum(1 for d in layout.values() if d)
        before = decode_stats()
        warm, warm_s = decode_all()
        warm_loop = decode_stats() - before
        qt.flash_attention = spy
        try:
            reset_launch_counts()
            before = decode_stats()
            laid, laid_s = decode_all()
            launches = launch_counts()
            loop = decode_stats() - before
        finally:
            qt.flash_attention = flash
    text = lm.cfg
    for i, ((t0, l0, z0), (t1, l1, z1)) in enumerate(zip(whole + whole, warm + laid)):
        if not (torch.equal(t0, t1) and torch.equal(l0, l1)):
            raise AssertionError(f"serve tp: request {i}'s tokens differ from the unsharded "
                                 f"decode: {t0.tolist()} / {l0.tolist()} vs {t1.tolist()} / "
                                 f"{l1.tolist()}")
        if not torch.equal(z0, z1):
            raise AssertionError(f"serve tp: request {i}'s traj latents differ by "
                                 f"{(z0 - z1).abs().max().item()}")
    L = text.num_hidden_layers
    if launches["K1"] != len(prompts) * L or dict(heads) != {
            (text.num_attention_heads, text.num_key_value_heads): len(prompts) * L}:
        raise AssertionError(f"serve tp: K1 launches {launches['K1']} on heads {dict(heads)}, "
                             f"expected {len(prompts) * L} on ({text.num_attention_heads}, "
                             f"{text.num_key_value_heads})")
    if (not warm_loop["captures"] or loop["captures"] or not loop["replays"]
            or any(launches[k] for k in ("K4", "K5", "K6a", "K6b", "K7"))):
        raise AssertionError(f"serve tp: the warm pass captured {dict(warm_loop)}, the counted "
                             f"pass ran {dict(loop)} (replays only), launches {launches} (no int8 "
                             f"kernel)")
    print(f"phase serve_tp: path=serve_tp mesh=dp1xtp1 backend=nccl world=1 "
          f"split_params={split} local_heads=({text.num_attention_heads}, "
          f"{text.num_key_value_heads}) prompts_T={[int(a[1].shape[1]) for a in prompts]} "
          f"new_tokens={MAX_NEW_TOKENS} generated={[int(l[0]) for _, l, _ in laid]} "
          f"tokens_equal=True latents_equal=True request_s={[round(x, 4) for x in laid_s]} "
          f"unsharded_request_s={[round(x, 4) for x in whole_s]} "
          f"warm_request_s={[round(x, 4) for x in warm_s]} warm_loop={dict(warm_loop)} "
          f"k1_launches_local_heads={launches['K1']} k1_heads={dict(heads)} "
          f"decode_loop={dict(loop)} launches={launches} gpu={gpu_line()!r}")
    return {"serve_tp": launches}


# ------------------------------------------------------------ checkpoint
#: RAM kept free beside checkpoints on a RAM-backed file system
CKPT_RAM_HEADROOM = 16 * 2**30


def _file_system(path: Path) -> str:
    """The type of the file system that holds path (/proc/mounts)."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            mount, fs = line.split()[1:3]
            if len(mount) > len(best) and (str(path) + "/").startswith(mount.rstrip("/") + "/"):
                best, kind = mount, fs
    return kind


def checkpoint_root(need_bytes: int) -> Path:
    """A new directory for the run's checkpoints: in the process's temporary
    directory (TMPDIR), else in build/chip_smoke of the checkout, on the
    first with room for `need_bytes` (the bf16 checkpoint, the int8 and
    the int4 one) with 10% to spare, and on a RAM-backed file system also in free
    RAM; raises when neither has it. Nothing outside the checkout and
    TMPDIR is written, so a run killed before its clean-up leaves nothing
    behind that outlives them."""
    import shutil
    import tempfile

    seen = []
    for root in (Path(tempfile.gettempdir()).resolve(), WORK_DIR):
        root.mkdir(parents=True, exist_ok=True)
        free, fs = shutil.disk_usage(root).free, _file_system(root)
        if fs in ("tmpfs", "ramfs"):
            with open("/proc/meminfo") as f:
                avail = next(int(line.split()[1]) * 1024 for line in f
                             if line.startswith("MemAvailable:"))
            free = min(free, avail - CKPT_RAM_HEADROOM)
        seen.append(f"{root} ({fs}): {free / 1e9:.1f} GB")
        if free >= 1.1 * need_bytes:
            path = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root))
            print(f"phase checkpoint: root={path} file_system={fs} free_gb={free / 1e9:.1f} "
                  f"need_gb={need_bytes / 1e9:.1f} candidates={seen}")
            return path
    raise AssertionError(f"no room for {need_bytes / 1e9:.1f} GB of checkpoints: {seen}")


def state_digests(module) -> dict:
    """sha256 of every state tensor's bit pattern (with its dtype and
    shape), by name; copied to the host and hashed by 8 threads."""
    import hashlib

    import torch

    def digest(item):
        name, t = item
        h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
        return name, h.hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(digest, module.state_dict().items()))


def check_digests(what: str, got: dict, want: dict) -> None:
    bad = sorted(k for k in want.keys() | got.keys() if got.get(k) != want.get(k))
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} tensors differ from the seed-0 "
                             f"build by digest, e.g. {bad[:5]}")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def phase_checkpoint_write(policy, root: Path) -> dict:
    """Write the parity phase's 7B bf16 policy as an HF-layout sharded
    safetensors checkpoint (`convert.hf_state_dict`, HF's 5 GiB shards and
    index) under root, after taking every tensor's digest. Returns the
    directory, the digests and the byte count."""
    import torch

    from internnav_tpu_torch.model.weights.convert import hf_state_dict
    from internnav_tpu_torch.model.weights.safetensors_io import save_sharded

    t0 = time.perf_counter()
    digests = state_digests(policy.model)
    digest_s = time.perf_counter() - t0
    hf_dir = root / "hf"
    t0 = time.perf_counter()
    files = save_sharded(hf_state_dict(policy.model), str(hf_dir))
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    nbytes = dir_bytes(hf_dir)
    print(f"phase checkpoint: write layout=hf dir={hf_dir} files={len(files)} "
          f"tensors={len(digests)} gb={nbytes / 1e9:.3f} write_s={write_s:.2f} "
          f"write_gb_per_s={nbytes / 1e9 / write_s:.3f} digest_s={digest_s:.2f} "
          f"gpu={gpu_line()!r}")
    return {"dir": hf_dir, "digests": digests, "bytes": nbytes}


def phase_checkpoint_load_realtime(device, hf: dict, weight_dtype: str = "int8"):
    """The realtime policy from the HF-layout checkpoint, quantized on load
    to `weight_dtype` (`serve.build_policy("realtime", ckpt=...,
    weight_dtype=...)`), held bitwise equal by digest to
    `InternVLAN1Policy.build` of the realtime profile in that format from
    seed 0, which is built first (its digests and peak device memory taken,
    then freed). The load's peak device memory must not exceed the build's.
    Returns (the loaded policy, its load seconds, the build's digests)."""
    import torch

    from internnav_tpu_torch.realworld import serve

    torch.cuda.reset_peak_memory_stats(device)
    base_gib = torch.cuda.memory_allocated(device) / 2**30
    t0 = time.perf_counter()
    built = serve.build_policy("realtime", device=device, weight_dtype=weight_dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    want = state_digests(built.model)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loaded = serve.build_policy("realtime", device=device, ckpt=str(hf["dir"]),
                                weight_dtype=weight_dtype)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    resident_gib = torch.cuda.memory_allocated(device) / 2**30
    check_digests(f"serve realtime {weight_dtype} from the HF-layout checkpoint",
                  state_digests(loaded.model), want)
    if load_peak_gib > build_peak_gib:
        raise AssertionError(f"the {weight_dtype} load peaked at {load_peak_gib:.2f} GiB, above "
                             f"the random realtime build's {build_peak_gib:.2f} GiB")
    print(f"phase checkpoint: load layout=hf profile=realtime weight_dtype={weight_dtype} "
          f"quantized_on_load=True "
          f"read_gb={hf['bytes'] / 1e9:.3f} load_s={load_s:.2f} "
          f"load_gb_per_s={hf['bytes'] / 1e9 / load_s:.3f} load_peak_mem_gib={load_peak_gib:.2f} "
          f"random_build_s={build_s:.2f} random_build_peak_mem_gib={build_peak_gib:.2f} "
          f"resident_gib={resident_gib:.2f} before_gib={base_gib:.2f} "
          f"digests_equal={len(want)}/{len(want)} gpu={gpu_line()!r}")
    return loaded, load_s, want


def phase_checkpoint_save_native(policy, root: Path, name: str = "native") -> Path:
    """`save_pretrained` of a loaded quantized policy into root/name."""
    native = root / name
    t0 = time.perf_counter()
    policy.save_pretrained(str(native))
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(native)
    print(f"phase checkpoint: save layout=native weight_dtype={policy.cfg.text.weight_dtype} "
          f"dir={native} gb={nbytes / 1e9:.3f} save_s={save_s:.2f} "
          f"save_gb_per_s={nbytes / 1e9 / save_s:.3f} gpu={gpu_line()!r}")
    return native


# ------------------------------------------------------- int4 and W8A16
@contextlib.contextmanager
def text_format(policy, **changes):
    """`policy` with its text config's fields changed (decode_act_dtype,
    kv_dtype) on the policy and on every module that holds the config,
    restored on the way out: the same weights in another decode or cache
    format, without a second 7B build."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import QwenTextConfig

    lm = policy.model.language_model
    old_cfg, old_text = policy.cfg, lm.cfg
    mods = [m for m in lm.modules() if isinstance(getattr(m, "cfg", None), QwenTextConfig)]
    text = dataclasses.replace(old_text, **changes)
    for m in mods:
        m.cfg = text
    policy.cfg = policy.model.cfg = dataclasses.replace(old_cfg, text=text)
    try:
        yield policy
    finally:
        for m in mods:
            m.cfg = old_text
        policy.cfg = policy.model.cfg = old_cfg


@contextlib.contextmanager
def plain_prefill_attention():
    """The text model's prefill attention on its plain version
    (`mha_reference`) instead of K1, on the card: the arithmetic of the
    bf16-cache decode attention (also a plain version there)."""
    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
    from internnav_tpu_torch.ops import flash_attention as fa

    kernel = qt.flash_attention
    qt.flash_attention = (lambda q, k, v, causal=False, segment_ids=None, tile_tables=None:
                          fa.mha_reference(q, k, v, causal=causal, segment_ids=segment_ids))
    try:
        yield
    finally:
        qt.flash_attention = kernel


def check_decode_equals_reprefill(device, policy, T: int = 96,
                                  k1_gap_limit: float | None = None) -> dict:
    """JAX's decode invariant (tests/test_int8_decode.py:248-270) on the 7B
    policy's text model, with a bf16 KV cache as there: the cached
    decode_step of token T gives the logits of an uncached prefill of the
    T + 1 tokens within rtol = atol = REPREFILL_TOL (that test's). The
    prefills attend through the plain version, the arithmetic of the
    bf16-cache decode attention: K1 rounds P to bf16 for its P V product,
    and through 28 layers of int8 codes that alone moves the W8A8 and
    W4A8 logits by about 1 on an H100. So the check holds the decode
    path's own work: the cache writes and positions, K6b's or K9's decode
    tiles against their prefill tiles, the lm_head, K7-free bf16 caches.
    The gap with K1 in the prefills (the real path) is held too: within
    K1_GAP_LOGIT_FRAC of the largest logit, and within `k1_gap_limit`
    where given (the int4 policy's: K1_GAP_FACTOR times the W8A8
    policy's gap in the same run), so it cannot grow unseen."""
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import pad_caches

    lm = policy.model.language_model
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, lm.cfg.vocab_size, (1, T + 1), generator=g).to(device)
    pos = torch.arange(T + 1, device=device)[None, None].expand(3, 1, T + 1)

    def gap():
        with torch.no_grad():
            _, _, caches = lm(lm.embed(ids[:, :T]), pos[..., :T].contiguous())
            dec, _, _ = lm.decode_step(lm.embed(ids[:, T:]), pos[..., T:].contiguous(),
                                       pad_caches(caches, T + 1),
                                       torch.full((1,), T, device=device))
            full, _, _ = lm(lm.embed(ids), pos,
                            logits_indices=torch.full((1,), T, device=device))
        return dec.float(), full[:, 0].float()

    with text_format(policy, kv_dtype="bf16"):
        k1_dec, k1_full = gap()
        with plain_prefill_attention():
            dec, full = gap()
    err = (dec - full).abs().max().item()
    if not torch.allclose(dec, full, atol=REPREFILL_TOL, rtol=REPREFILL_TOL) \
            or not torch.isfinite(dec).all():
        raise AssertionError(f"{lm.cfg.weight_dtype} decode_step differs from the re-prefill "
                             f"by {err} (max |logit| {full.abs().max().item():.4f})")
    out = {"max_abs_err": err, "max_abs_logit": full.abs().max().item(),
           "argmax_equal": bool(dec.argmax() == full.argmax()),
           "with_k1_max_abs_err": (k1_dec - k1_full).abs().max().item(),
           "with_k1_argmax_equal": bool(k1_dec.argmax() == k1_full.argmax()),
           "with_k1_limit": min(K1_GAP_LOGIT_FRAC * k1_full.abs().max().item(),
                                math.inf if k1_gap_limit is None else k1_gap_limit)}
    print(f"phase serve: decode_equals_reprefill weight_dtype={lm.cfg.weight_dtype} T={T} "
          f"kv_dtype=bf16 prefill_attention=plain tol={REPREFILL_TOL} "
          f"{' '.join(f'{k}={v}' for k, v in out.items())} gpu={gpu_line()!r}")
    if not out["with_k1_max_abs_err"] <= out["with_k1_limit"]:
        raise AssertionError(f"{lm.cfg.weight_dtype} decode_step differs from the re-prefill "
                             f"through K1 by {out['with_k1_max_abs_err']}, past "
                             f"{out['with_k1_limit']}")
    return out


def check_graph_equals_eager(policy, what: str) -> None:
    """The same request twice from a reset episode: its decode loop
    replayed from the captured graphs, then run eagerly
    (`policy.eager_decode`); tokens and the traj latents bit for bit."""
    import numpy as np
    import torch

    frame, _ = request_frames(np.random.default_rng(5))
    out = []
    for eager in (False, True):
        policy.reset()
        policy.eager_decode = eager
        try:
            o = policy.s2_step(frame, INSTRUCTION, max_new_tokens=MAX_NEW_TOKENS)
            torch.cuda.synchronize()
        finally:
            policy.eager_decode = False
        latent = None if o.output_latent is None else o.output_latent.clone()
        out.append((list(policy.last_gen_tokens), latent))
    (tg, lg), (te, le) = out
    if tg != te or (lg is None) != (le is None) or (lg is not None and not torch.equal(lg, le)):
        raise AssertionError(f"{what}: the graph decode differs from the eager one")
    print(f"phase serve: {what} graph_equals_eager=True generated_tokens={len(tg)} "
          f"latent={None if lg is None else tuple(lg.shape)}")


def phase_w8a16(device, policy, label: str) -> dict:
    """W8A16 (int8 weights) or W4A16 (int4) decode on the same policy
    (`text_format(decode_act_dtype="bf16")`): 2 requests through the server
    with their launches held to `expected_serve_launches` (K10 for every
    decode and chunk projection and each decode step's lm_head, no K6a at
    decode, the prefill on K6b or K9), then one request through the graph
    and eagerly, bit for bit. Returns the launches by path."""
    with text_format(policy, decode_act_dtype="bf16"):
        by_path = phase_serve(device, "realtime", policy, 0.0, label=label, requests=2,
                              long_request=False)
        check_graph_equals_eager(policy, label)
    return by_path


def phase_evaluate_int4(device, ckpt: Path, want: dict) -> dict:
    """The evaluator loop of `scripts/torch/bench_evaluator.py
    --weight-dtype int4 --ckpt <native int4 dir>` (4 cohorts x 12 streams,
    str hashing pinned): the policy held equal by digest to the int4
    seed-0 build, one warm run and one timed run of the same episodes of
    SHORT_MAX_STEP steps;
    every episode ends, K9 and K6b (the 8-bit lm_head) launch, K10 does
    not, and no plain version runs. Returns the timed run's launches."""
    import shutil

    import torch

    bench = bench_entry()
    t0 = time.perf_counter()
    inner = bench.build_inner(device, ckpt=str(ckpt), weight_dtype="int4")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check_digests("evaluate int4 from the native checkpoint", state_digests(inner.model), want)
    plain = collections.Counter()
    restore = _plain_spies(plain)
    out_dir = WORK_DIR / "evaluate_int4"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        warm = bench.evaluator_run(inner, str(out_dir / "warm"), max_step=SHORT_MAX_STEP)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        run = bench.evaluator_run(inner, str(out_dir / "run0"), max_step=SHORT_MAX_STEP)
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        _restore(restore)
    if plain:
        raise AssertionError(f"evaluate int4: plain versions ran on the card: {dict(plain)}")
    n = bench.BATCH * bench.COHORTS
    for r in (warm, run):
        ends = collections.Counter(e["fail_reason"] for e in r["records"])
        if len(r["records"]) != n or set(ends) - {"", "exceed_max_step"}:
            raise AssertionError(f"evaluate int4: episodes did not all end: {dict(ends)}")
    if run["episode_steps"] != warm["episode_steps"]:
        raise AssertionError("evaluate int4: the timed run took other episodes")
    if not launches["K9"] or not launches["K6b"] or launches["K10"] or launches["K6b_fused"]:
        raise AssertionError(f"evaluate int4: K9 and the lm_head's K6b must launch, K10 and "
                             f"fused K6b not: {launches}")
    print(f"phase evaluate: path=evaluate_int4 weight_dtype=int4 cohorts={bench.COHORTS} "
          f"rows={bench.BATCH} episodes={n} max_step={SHORT_MAX_STEP} load_s={build_s:.2f} "
          f"digests_equal={len(want)}/{len(want)} "
          f"warm_actions_per_s={warm['actions_per_sec']:.4f} "
          f"actions_per_s={run['actions_per_sec']:.4f} wall_clock_s={run['wall_clock_s']:.4f} "
          f"actions_timed={run['actions_timed']} "
          f"action_latency_ms_p50={run['action_latency_p50_ms']} "
          f"action_latency_ms_p99={run['action_latency_p99_ms']} launches={launches} "
          f"plain_version_calls=0 peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    del inner
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_int4": launches}


# --------------------------------------------------------- serve batched
# the checked cycles' instructions: one per stream, all of INSTRUCTION's
# length (a word is a token), so every prompt stays BATCH_PROMPT tokens long
OBJECTS = ("table", "sofa", "stairs", "plant")
ORDINALS = ("first", "second", "third", "fourth")
SIDES = ("left", "right", "end")


def own_instruction(ci: int, r: int) -> str:
    return (f"go past the {OBJECTS[ci % 4]} and stop at the {ORDINALS[r % 4]} door on the "
            f"{SIDES[(r // 4) % 3]}")


def expected_batched_launches(policy, cycles: int, cohorts: int, rows: int) -> dict:
    """Launches of `cycles` shared-decode cycles of `cohorts` cohorts of
    `rows` rows at BATCH_HW, each decoding the full BATCH_NEW_TOKENS budget:
    a cycle is each cohort's vision call over its rows' frames, its prefill
    and its BATCH_S1_CALLS System-1 denoises, then one grouped decode and
    latent chunk over the cohorts' cache groups
    (`expected_pipelined_launches`)."""
    prefills = cycles * cohorts
    return expected_pipelined_launches(
        policy, [(rows, BATCH_HW, BATCH_HW)] * prefills, prefills,
        [(cohorts, cohorts * rows, BATCH_NEW_TOKENS, BATCH_NEW_TOKENS - 1)] * cycles,
        prefills * BATCH_S1_CALLS)


def phase_serve_batched(device) -> dict:
    """The headline serving geometry of the JAX package's bench.py
    (`bench_pipelined`): the 7B realtime policy behind PipelinedN1Server,
    BATCH_COHORTS cohorts of BATCH_ROWS streams, 224x224 frames, histories
    saturated at 9 frames, shared grouped decode of BATCH_NEW_TOKENS tokens
    (the stop id pinned to -7, which no token is, as bench.py pins it: every
    cycle decodes the full budget), 32 sample trajectories, two System-1
    calls a cycle. One warm cycle (the captures); then three checked
    cycles in which every stream has its own frames, history and
    instruction: with the graph, eagerly (tokens, latents and trajectories
    bitwise equal to the graph's) and with a per-cohort decode
    (`s2_submit`: tokens exactly equal to the shared decode's, latents
    within SHARED_TOL); then BATCH_STREAMS timed streams of BATCH_CYCLES
    cycles of the headline frames (one frame for every stream, as
    bench.py), whose launches are held to `expected_batched_launches`.
    Every prompt must be BATCH_PROMPT tokens in a BATCH_PROMPT_T bucket,
    the shapes of the batched kernel rows. Returns the timed streams'
    launches."""
    import numpy as np
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1.decode_graph import DecodeLoop
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import to_device
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import PipelinedN1Server
    from internnav_tpu_torch.realworld import serve

    t0 = time.perf_counter()
    policy = serve.build_policy("realtime", device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    policy.tokenizer.eos_token_id = -7  # no token: the full decode budget
    cfg = policy.cfg
    server = PipelinedN1Server(policy, BATCH_ROWS, cohorts=BATCH_COHORTS)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (BATCH_HW, BATCH_HW, 3)).astype(np.uint8)
    imgs = np.stack([img] * BATCH_ROWS)
    own_imgs = rng.integers(0, 256, (BATCH_COHORTS, BATCH_ROWS, BATCH_HW, BATCH_HW, 3),
                            dtype=np.uint8)
    own_hist = rng.integers(0, 256, (BATCH_COHORTS, BATCH_ROWS, 8, BATCH_HW, BATCH_HW, 3),
                            dtype=np.uint8)
    outputs, prompts = [], set()

    def record_prompts(prep):
        def wrapper(*a, **kw):
            g = prep(*a, **kw)
            prompts.add((g["T"], tuple(g["prompt_len"].tolist())))
            return g
        return wrapper

    for pol in server.cohorts:
        pol._prep_group = record_prompts(pol._prep_group)

    def saturate(own: bool):
        """Every slot mid-episode: 8 history frames, a memory frame on the
        device; each cohort's noise generator from its seed again. `own`:
        each stream its own history and instruction."""
        for ci, pol in enumerate(server.cohorts):
            pol.reset([own_instruction(ci, r) if own else INSTRUCTION
                       for r in range(BATCH_ROWS)])
            pol._generator.manual_seed(pol.seed)
            for r, s in enumerate(pol.slots):
                s.rgb_list = list(own_hist[ci, r]) if own else [img] * 8
                s.episode_idx = 8
                s.s1_mem_frame = to_device(s.rgb_list[-1], device)

    def on_cycle(ci, t, s2out, s1res):
        # kept, and checked after the stream (a check here would wait for
        # the device inside the timed stream)
        outputs.append((ci, t, [s.llm_output for s in server.cohorts[ci].slots], s2out, s1res))
        for s in server.cohorts[ci].slots:  # a new latent: its memory frame is encoded next
            s.s1_mem_feats = None

    def checked():
        """Every kept cycle's outputs well formed and finite; per cohort and
        cycle its texts, latents and trajectories (on the host)."""
        got = {}
        for ci, t, texts, s2out, s1res in outputs:
            lats = [o.output_latent for o in s2out]
            if len(s2out) != BATCH_ROWS or len(s1res) != BATCH_S1_CALLS \
                    or any(len(x.split()) != BATCH_NEW_TOKENS for x in texts) \
                    or any(lat is None for lat in lats):
                raise AssertionError(f"cohort {ci} cycle {t}: malformed S2 outputs {texts}")
            lat = torch.cat(lats).cpu()
            if tuple(lat.shape) != (BATCH_ROWS, cfg.n_query, cfg.text.hidden_size) \
                    or not torch.isfinite(lat).all():
                raise AssertionError(f"cohort {ci} cycle {t}: S2 latents {tuple(lat.shape)} "
                                     "not finite / not well formed")
            for call in s1res:
                for o in call:
                    if o.trajectory.shape != (BATCH_TRAJS, cfg.predict_step_nums, 3) \
                            or not np.isfinite(o.trajectory).all():
                        raise AssertionError(f"cohort {ci} cycle {t}: trajectory "
                                             f"{o.trajectory.shape} not finite / well formed")
            trajs = np.stack([o.trajectory for call in s1res for o in call])
            got[(ci, t)] = (texts, lat, trajs)
        outputs.clear()
        return got

    def stream(cycles, own=False, shared=True, host_stats=None):
        frames = (lambda ci, t, ph: own_imgs[ci]) if own else (lambda ci, t, ph: imgs)
        server.serve_stream(frames, cycles, max_new_tokens=BATCH_NEW_TOKENS,
                            num_sample_trajs=BATCH_TRAJS, s1_calls=BATCH_S1_CALLS,
                            on_cycle=on_cycle, shared_decode=shared, shared_s1=False,
                            host_stats=host_stats)

    saturate(own=False)
    t = time.perf_counter()
    stream(1)  # the captures
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    checked()
    # the decode loop's seconds a token in each mode, between device
    # synchronisations (in the checked cycles only)
    loop_run, loop_s = DecodeLoop.run, {}

    def timed_run(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = loop_run(self, *a, **kw)
        torch.cuda.synchronize()
        loop_s.setdefault(run_name, []).append((time.perf_counter() - t) / self.steps_run)
        return out

    runs = {}
    DecodeLoop.run = timed_run
    try:
        for run_name, eager, shared in (("graph", False, True), ("eager", True, True),
                                        ("per_cohort", False, False)):
            saturate(own=True)
            policy.eager_decode = eager
            t = time.perf_counter()
            stream(1, own=True, shared=shared)
            runs[run_name] = (time.perf_counter() - t, checked())
    finally:
        DecodeLoop.run = loop_run
        policy.eager_decode = False
    graph = runs["graph"][1]
    lat_all = torch.cat([graph[k][1] for k in sorted(graph)]).flatten(1)
    if torch.unique(lat_all, dim=0).shape[0] != BATCH_DECODE_M:
        raise AssertionError("serve batched: two streams with their own inputs gave one latent")
    shared_err, shared_traj_err = 0.0, 0.0
    for key, (texts, lat, trajs) in graph.items():
        etexts, elat, etrajs = runs["eager"][1][key]
        if texts != etexts or not torch.equal(lat, elat) or not np.array_equal(trajs, etrajs):
            raise AssertionError(f"cohort/cycle {key}: graph replay and eager decode differ "
                                 f"(tokens equal: {texts == etexts})")
        ptexts, plat, ptrajs = runs["per_cohort"][1][key]
        shared_err = max(shared_err, (lat.float() - plat.float()).abs().max().item())
        shared_traj_err = max(shared_traj_err, float(np.abs(trajs - ptrajs).max()))
        if texts != ptexts or not torch.allclose(lat.float(), plat.float(), atol=SHARED_TOL,
                                                 rtol=SHARED_TOL):
            raise AssertionError(f"cohort/cycle {key}: the shared decode and the per-cohort "
                                 f"decode differ (tokens equal: {texts == ptexts}, latents by "
                                 f"{shared_err})")

    saturate(own=False)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    before = decode_stats()
    walls, host_stats = [], {}
    for rep in range(BATCH_STREAMS):
        t = time.perf_counter()
        stream(BATCH_CYCLES, host_stats=host_stats if rep == BATCH_STREAMS - 1 else None)
        walls.append(time.perf_counter() - t)
    loop = decode_stats() - before
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    checked()
    cycles = BATCH_STREAMS * BATCH_CYCLES
    if dict(loop) != {"steps": cycles * BATCH_NEW_TOKENS, "replays": cycles * BATCH_NEW_TOKENS,
                      "logits_steps": cycles * (BATCH_NEW_TOKENS - 1)}:
        raise AssertionError(f"serve batched: decode loop {dict(loop)} over {cycles} cycles")
    if prompts != {(BATCH_PROMPT_T, (BATCH_PROMPT,) * BATCH_ROWS)}:
        raise AssertionError(f"serve batched: prompt buckets and lengths {prompts}, the kernel "
                             f"rows hold {BATCH_PROMPT} in {BATCH_PROMPT_T}")
    want = expected_batched_launches(policy, cycles, BATCH_COHORTS, BATCH_ROWS)
    if launches != want:
        raise AssertionError(f"serve batched: kernel launches {launches}, expected {want}")
    buffers = policy.decode_buffers
    streams = BATCH_COHORTS * BATCH_ROWS
    aps = [ACTIONS_PER_CYCLE * streams * BATCH_CYCLES / w for w in walls]
    sums = {k: round(sum(x), 4) for k, x in host_stats.items()}
    ms = {name: [round(1e3 * x, 4) for x in xs] for name, xs in loop_s.items()}
    print(f"phase serve batched: profile=realtime cohorts={BATCH_COHORTS} rows={BATCH_ROWS} "
          f"hw={BATCH_HW} history_frames=9 prompt={BATCH_PROMPT} prompt_T={BATCH_PROMPT_T} "
          f"max_new_tokens={BATCH_NEW_TOKENS} stop_id=-7 sample_trajs={BATCH_TRAJS} "
          f"s1_calls={BATCH_S1_CALLS} shared_decode=True shared_s1=False build_s={build_s:.2f} "
          f"warm_cycle_s={warm_s:.4f} graph_cycle_s={runs['graph'][0]:.4f} "
          f"eager_cycle_s={runs['eager'][0]:.4f} per_cohort_cycle_s={runs['per_cohort'][0]:.4f} "
          f"graph_vs_eager=bitwise shared_vs_per_cohort_tokens=equal "
          f"shared_vs_per_cohort_latent_max_abs_err={shared_err} "
          f"shared_vs_per_cohort_traj_max_abs_err={shared_traj_err} "
          f"decode_ms_per_token={ms} "
          f"stream_wall_s={[round(w, 4) for w in walls]} "
          f"actions_per_s={[round(a, 2) for a in aps]} actions_per_s_best={max(aps):.2f} "
          f"host_stats_sum_s={sums} last_stream_wall_s={walls[-1]:.4f} "
          f"decode_loop={dict(loop)} cache_sets={sum(len(x) for x in buffers._sets.values())} "
          f"loops={len(buffers._loops)} launches={launches} "
          f"peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return {"serve_batched": launches}


# -------------------------------------------------------------- evaluate
EVAL_RUNS = 2  # timed evaluator runs after the warm one
#: the step budget of the evaluate int4 and evaluate navdp runs: half the
#: headline's bench.MAX_STEP, to keep the script inside its time limit
SHORT_MAX_STEP = 12
#: the plain versions of the kernels, by ops module: none may run on the card
PLAIN_VERSIONS = {
    "flash_attention": ("mha_reference", "flash_backward_reference", "gqa_decode_reference",
                        "gqa_chunk_decode_reference"),
    "quant": ("quantize_rows", "rmsnorm_quantize_reference", "swiglu_quantize_reference",
              "w8a8_linear_reference", "write_kv_cache_reference", "rope_kv_write_reference",
              "w4a8_linear_reference", "w8a16_linear_reference"),
    "activations": ("silu_reference", "silu_mul_reference"),
}
EVAL_KERNELS = ("K1", "K4", "K5", "K6a", "K6b", "K7", "K8")


def bench_entry():
    """scripts/torch/bench_evaluator.py, the evaluator path's bench entry."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "torch" / "bench_evaluator.py"
    spec = importlib.util.spec_from_file_location("bench_evaluator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy(obj, name, counter, key, seconds=None):
    """Replace obj.name by a wrapper that counts its calls under key (and
    adds their host seconds to seconds[key]); returns the original."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        counter[key] += 1
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            if seconds is not None:
                seconds[key] += time.perf_counter() - t

    setattr(obj, name, wrapper)
    return fn


def _plain_spies(counter):
    """Spy on every plain version of a kernel (PLAIN_VERSIONS), counting
    their calls in `counter`; returns the (module, name, original)
    triples for `_restore`."""
    from internnav_tpu_torch.ops import activations as act
    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.ops import quant

    modules = {"flash_attention": fa, "quant": quant, "activations": act}
    return [(modules[m], name, _spy(modules[m], name, counter, f"{m}.{name}"))
            for m, names in PLAIN_VERSIONS.items() for name in names]


def _check_outputs(traj_shape, bad):
    """Check every agent output as the pipelined evaluator applies it (one
    action of the four, a finite trajectory of traj_shape), the malformed
    ones into `bad`; returns the original apply's triple for `_restore`."""
    import numpy as np

    from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as pipe

    apply = pipe._Cohort.apply

    def checked_apply(self, agent_out):
        for o in agent_out:
            traj = o.get("trajectory")
            if len(o["action"]) != 1 or o["action"][0] not in (0, 1, 2, 3) or (
                    traj is not None and (traj.shape != traj_shape
                                          or not np.isfinite(traj).all())):
                bad.append((o["action"], None if traj is None else traj.shape))
        return apply(self, agent_out)

    pipe._Cohort.apply = checked_apply
    return pipe._Cohort, "apply", apply


def _restore(spies) -> None:
    for obj, name, fn in reversed(spies):
        setattr(obj, name, fn)


#: the evaluate path's shapes checked after its timed runs: each kernel's
#: most launched signatures in the warm run, until they cover this share
#: of its launches, at least EVAL_SHAPES_MIN and at most EVAL_SHAPES_MAX
#: (K6a and K6b: a layer pass's prologues or projections at two row counts;
#: K8: System-1's SiLUs at each row count of a denoise, spread over 21
#: signatures)
EVAL_SHAPE_SHARE = 0.75
EVAL_SHAPES_MIN = 2
EVAL_SHAPES_MAX = {"K1": 4, "K4": 4, "K5": 4, "K6a": 8, "K6b": 10, "K7": 4, "K8": 10}


def _tensor_arg(t):
    """A small device tensor kept from a launch: its values, read later."""
    return t.detach().clone() if t is not None else None


class ShapeLog:
    """The evaluate path's kernel launches by signature: the shapes a
    kernel's plan and cost depend on. Spies on the kernels' CUDA wrappers
    record each launch (and, from the first launch of a signature outside
    a decode step, its segment ids or cache lengths). A decode step
    captured into a CUDA graph records its signatures once, under its
    loop and step variant, and each replay counts them again, as the
    launch counters do; the decode loop's own rows are taken at each
    group's prompt lengths plus half the steps it ran. `install` returns
    the (object, name, original) triples to restore."""

    def __init__(self):
        self.launches = collections.Counter()
        self.inputs = {}      # signature -> {name: tensor} of its first launch
        self.captured = collections.defaultdict(list)  # (loop, logits) -> signatures
        self.loop_lengths = {}  # (rows, Tmax) of a decode group -> positions mid-decode
        self.decode_rows = collections.Counter()  # a decode loop's rows -> its runs
        self._step = None     # (loop, logits) while a decode step runs

    def _record(self, sig, **inputs):
        import torch

        if torch.cuda.is_current_stream_capturing():
            self.captured[self._step].append(sig)
            return
        self.launches[sig] += 1
        if self._step is None and sig not in self.inputs:
            self.inputs[sig] = {k: _tensor_arg(v) for k, v in inputs.items()}

    def _spy(self, obj, name, signature):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            sig, inputs = signature(*args, **kwargs)
            self._record(sig, **inputs)
            return fn(*args, **kwargs)

        setattr(obj, name, wrapper)
        return obj, name, fn

    def install(self):
        import torch

        from internnav_tpu_torch.model.basemodel.internvla_n1 import decode_graph as dg
        from internnav_tpu_torch.ops import activations as act
        from internnav_tpu_torch.ops import flash_attention as fa
        from internnav_tpu_torch.ops import quant

        def k1(q, k, v, *, causal=False, segment_ids=None, **_):
            return (("K1", tuple(q.shape), k.shape[1], bool(causal)), {"seg": segment_ids})

        def k4(q, k_cache, v_cache, cache_len, *_, **__):
            return ("K4", q.shape[0], k_cache.shape[2], 1), {}

        def k5(q, k_cache, v_cache, cache_len, *_, **__):
            return ("K5", q.shape[0], k_cache.shape[2], q.shape[2]), {"lengths": cache_len}

        def rows(x):
            return x.numel() // x.shape[-1], x.shape[-1]

        def rmsnorm(x, weight, eps, residual=None):
            kind = "rmsnorm" if residual is None else "rmsnorm_residual"
            return ("K6a", kind, *rows(x)), {}

        def swiglu(gate, up):
            return ("K6a", "swiglu", *rows(gate)), {}

        def plain(x):
            return ("K6a", "plain_fp32" if x.dtype == torch.float32 else "plain", *rows(x)), {}

        def gemm_sig(xq, segments):
            w, s, b = segments[0]
            group = xq.shape[1] // s.shape[0] if s.dim() == 2 else None
            return (("K6b", xq.shape[0], tuple(sg[0].shape[0] for sg in segments), xq.shape[1],
                     b is not None, group), {})

        def gemm(xq, a_scale, weight_q, scale_q, bias=None):
            return gemm_sig(xq, [(weight_q, scale_q, bias)])

        def gemm_decode(xq, a_scale, segments):
            return gemm_sig(xq, segments)

        def rope_kv(q, k, v, cos, sin, k_entry, v_entry, cache_len):
            return (("K7", True, cos.shape[0], cos.shape[1], k_entry[0].shape[1]),
                    {"lengths": cache_len})

        def kv(k, v, k_entry, v_entry, cache_len):
            return (("K7", False, k.shape[0], k.shape[1], k_entry[0].shape[1]),
                    {"lengths": cache_len})

        def silu(gate, up=None):
            return ("K8", "silu" if up is None else "silu_mul", *rows(gate)), {}

        restore = [self._spy(mod, name, sig) for mod, name, sig in (
            (fa, "flash_attention_cuda", k1), (fa, "gqa_decode_int8_cuda", k4),
            (fa, "gqa_chunk_decode_int8_cuda", k5), (quant, "rmsnorm_quantize_cuda", rmsnorm),
            (quant, "swiglu_quantize_cuda", swiglu), (quant, "quantize_rows_cuda", plain),
            (quant, "w8a8_linear_cuda", gemm), (quant, "w8a8_decode_cuda", gemm_decode),
            (quant, "rope_kv_write_cuda", rope_kv), (quant, "write_kv_cache_cuda", kv),
            (act, "silu_cuda", silu))]
        loop = dg.DecodeLoop
        step, run_step, run, capture = loop._step, loop._run_step, loop.run, loop._capture

        def capture_spy(this, dev):
            for logits in (True, False):  # a new loop may take a dropped one's id
                self.captured.pop((id(this), logits), None)
            return capture(this, dev)

        def step_spy(this, logits):
            self._step = (id(this), logits)
            try:
                return step(this, logits)
            finally:
                self._step = None

        def run_step_spy(this, logits):
            if this.graphs:
                self.launches.update(self.captured[(id(this), logits)])
            return run_step(this, logits)

        def run_spy(this, first_tok, prompt_lengths, rope_deltas):
            out = run(this, first_tok, prompt_lengths, rope_deltas)
            self.decode_rows[sum(g.rows for g in this.groups)] += 1
            at = [int(x) + this.steps_run // 2 for x in prompt_lengths.tolist()]
            r = 0
            for g in this.groups:
                self.loop_lengths.setdefault((g.rows, g.Tmax), tuple(at[r:r + g.rows]))
                r += g.rows
            return out

        for name, fn in (("_step", step_spy), ("_run_step", run_step_spy), ("run", run_spy),
                         ("_capture", capture_spy)):
            restore.append((loop, name, getattr(loop, name)))
            setattr(loop, name, fn)
        return restore

    def by_kernel(self) -> dict:
        out = collections.defaultdict(list)
        for sig, n in self.launches.most_common():
            out[sig[0]].append((sig, n))
        return out

    def chosen(self) -> dict:
        """kernel -> [(signature, launches)] to check (EVAL_SHAPE_SHARE)."""
        picked = {}
        for kernel, sigs in self.by_kernel().items():
            total, covered, take = sum(n for _, n in sigs), 0, []
            for sig, n in sigs:
                if len(take) >= EVAL_SHAPES_MAX[kernel] or (
                        covered >= EVAL_SHAPE_SHARE * total and len(take) >= EVAL_SHAPES_MIN):
                    break
                take.append((sig, n))
                covered += n
            picked[kernel] = take
        return picked

    def lengths(self, sig):
        """Positions of a signature's rows: a decode group's from its loop,
        else those of its first launch (a token's keys for K4)."""
        kernel = sig[0]
        if kernel in ("K4", "K7") and (kernel == "K4" or sig[3] == 1):
            B, Tmax = (sig[1], sig[2]) if kernel == "K4" else (sig[2], sig[4])
            if (B, Tmax) in self.loop_lengths:
                return self.loop_lengths[(B, Tmax)]
        return tuple(int(x) for x in self.inputs[sig]["lengths"].tolist())


def eval_kernel_rows(device, log: ShapeLog) -> dict:
    """Each kernel of EVAL_KERNELS at the evaluate path's most launched
    signatures (`ShapeLog.chosen`), checked against its plain version and
    timed like the rows of phase kernels, on fresh random inputs (the
    segment ids and positions of the path); rows by kernel, each with the
    signature's warm-run launches and share."""
    import torch

    g = torch.Generator(device=device).manual_seed(3)
    by_kernel = log.by_kernel()
    rows = collections.defaultdict(list)
    for kernel, picked in log.chosen().items():
        total = sum(n for _, n in by_kernel[kernel])
        for sig, n in picked:
            extra = {"path": "evaluate", "warm_run_launches": n, "share": n / total}
            if kernel == "K1":
                (B, H, T, D), KV, causal = sig[1], sig[2], sig[3]
                seg = log.inputs[sig]["seg"]

                def rnd(*shape):
                    return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

                name = f"eval_{'text' if D == 128 else 'vision'}_B{B}_T{T}"
                rows[kernel].append(k1_row(name, rnd(B, H, T, D), rnd(B, KV, T, D),
                                           rnd(B, KV, T, D), seg, causal, extra))
            elif kernel in ("K4", "K5"):
                rows[kernel].append(decode_row(device, g, kernel, sig[2], log.lengths(sig),
                                               sig[3], extra))
            elif kernel == "K6a":
                rows[kernel].append(k6a_row(device, g, sig[1], sig[2], sig[3], extra))
            elif kernel == "K6b":
                _, M, widths, K, bias, group = sig
                rows[kernel].append(gemm_row(device, g, M, widths, K, bias, group, extra=extra))
            elif kernel == "K8":
                rows[kernel].append(k8_row(device, g, *sig[1:], extra=extra))
            else:
                _, rotary, B, n, Tmax = sig
                rows[kernel].append(kv_write_row(device, g, rotary, n, log.lengths(sig), Tmax,
                                                 extra))
        torch.cuda.empty_cache()
    return rows


def phase_evaluate(device, ckpt: Path, want: dict) -> dict:
    """The evaluator-path headline through the bench entry's functions
    (`build_inner` from the native int8 checkpoint `ckpt`, held equal to
    the realtime seed-0 build by digest (`want`), `evaluator_run`,
    `assemble`): one warm run, then
    EVAL_RUNS timed runs of the same episodes, with each run's host
    seconds by call (System-2 submits, the shared decode's flush, System-2
    and System-1 collects, System-1 submits, and the env apply: FakeEnv
    stepping and the evaluator's bookkeeping). Checks every agent output
    as the evaluator applies it (one action of the four, a finite
    trajectory of BATCH_TRAJS x predict_step_nums x 3), every episode's
    end, each kernel of EVAL_KERNELS launched in the timed runs, and no
    call of a plain version in the whole phase (PLAIN_VERSIONS, spied on
    from the policy's build on). Returns the timed runs' launches."""
    import shutil

    import torch

    from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as pipe
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import (
        BatchedN1Policy,
        SharedDecodePool,
    )

    bench = bench_entry()
    if os.environ.get("PYTHONHASHSEED") != bench.HASH_SEED:
        raise AssertionError("evaluate: str hashing is not pinned to the bench entry's seed")
    t0 = time.perf_counter()
    inner = bench.build_inner(device, ckpt=str(ckpt))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check_digests("evaluate from the native checkpoint", state_digests(inner.model), want)
    traj_shape = (bench.NUM_SAMPLE_TRAJS, inner.cfg.predict_step_nums, 3)
    bad, calls, plain = [], collections.Counter(), collections.Counter()
    host_s = collections.Counter()
    restore = [_check_outputs(traj_shape, bad), *_plain_spies(plain)]
    restore += [(cls, name, _spy(cls, name, calls, key, host_s)) for cls, name, key in (
        (BatchedN1Policy, "s2_prefill_submit", "s2_submit"),
        (BatchedN1Policy, "s2_submit", "s2_submit"), (SharedDecodePool, "flush", "shared_decode"),
        (BatchedN1Policy, "s2_collect", "s2_collect"), (BatchedN1Policy, "s1_submit", "s1_submit"),
        (BatchedN1Policy, "s1_collect", "s1_collect"), (pipe._Cohort, "apply", "env_apply"))]
    out_dir = WORK_DIR / "evaluate"
    shutil.rmtree(out_dir, ignore_errors=True)
    runs, per_run = [], []
    shapes = ShapeLog()
    try:
        # the warm run's launches by signature; its spies go before the timed runs
        before, undo = launch_counts(), shapes.install()
        try:
            t = time.perf_counter()
            warm = bench.evaluator_run(inner, str(out_dir / "warm"))
            warm_s = time.perf_counter() - t
        finally:
            for obj, name, fn in reversed(undo):
                setattr(obj, name, fn)
        warm_launches = {k: v - before[k] for k, v in launch_counts().items()}
        warm_calls = dict(calls)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        for i in range(EVAL_RUNS):
            calls.clear()
            host_s.clear()
            before = decode_stats()
            runs.append(bench.evaluator_run(inner, str(out_dir / f"run{i}")))
            per_run.append({"calls": dict(calls), "decode": dict(decode_stats() - before),
                            "host_s": {k: round(v, 4) for k, v in host_s.items()}})
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        _restore(restore)
    if bad:
        raise AssertionError(f"evaluate: {len(bad)} malformed agent outputs, e.g. {bad[:3]}")
    if plain:
        raise AssertionError(f"evaluate: plain versions ran on the card: {dict(plain)}")
    missing = [k for k in EVAL_KERNELS if not launches[k]]
    if missing or launches["K2"] or launches["K3"]:
        raise AssertionError(f"evaluate: kernels {missing} never launched, or a backward "
                             f"kernel did: {launches}")
    n = bench.BATCH * bench.COHORTS
    for r in (warm, *runs):
        ends = collections.Counter(e["fail_reason"] for e in r["records"])
        if len(r["records"]) != n or set(ends) - {"", "exceed_max_step"} \
                or not all(1 <= e["steps"] <= bench.MAX_STEP for e in r["records"]):
            raise AssertionError(f"evaluate: episodes did not all end: {dict(ends)}")
        if r["episode_steps"] != warm["episode_steps"]:
            raise AssertionError("evaluate: a timed run took other episodes than the warm run")
    logged = shapes.by_kernel()
    for k in EVAL_KERNELS:  # every launch of the warm run has its signature
        if sum(n for _, n in logged[k]) != warm_launches[k]:
            raise AssertionError(f"evaluate: {k} launched {warm_launches[k]} times in the warm "
                                 f"run, the shape log holds {sum(n for _, n in logged[k])}")
    for k in EVAL_KERNELS:
        print(f"phase evaluate: shapes {k} signatures={len(logged[k])} launches="
              f"{warm_launches[k]} most_launched={[(list(s[1:]), n) for s, n in logged[k][:12]]}")
    print(f"phase evaluate: shapes decode_runs_by_rows={sorted(shapes.decode_rows.items())} "
          f"group_positions(rows,Tmax)={sorted(shapes.loop_lengths.items())}")
    result = bench.assemble(runs)
    steps = collections.Counter(warm["episode_steps"])
    print(f"phase evaluate: profile=realtime cohorts={bench.COHORTS} rows={bench.BATCH} "
          f"hw={bench.IMAGE_HW} episodes={n} max_step={bench.MAX_STEP} "
          f"max_new_tokens={bench.DECODE_TOKENS} stop_id={bench.STOP_ID} "
          f"sample_trajs={bench.NUM_SAMPLE_TRAJS} shared_decode=True shared_s1=False "
          f"overlap_apply=False weights=native_checkpoint load_s={build_s:.2f} "
          f"digests_equal={len(want)}/{len(want)} warm_run_s={warm_s:.4f} "
          f"warm_actions_per_s={warm['actions_per_sec']:.4f} warm_calls={warm_calls} "
          f"actions_per_s={[round(r['actions_per_sec'], 4) for r in runs]} "
          f"actions_per_s_median={result['value']:.4f} "
          f"vs_a100_estimate={result['vs_baseline']:.4f} "
          f"wall_clock_s={[round(r['wall_clock_s'], 4) for r in runs]} "
          f"actions_timed={[r['actions_timed'] for r in runs]} "
          f"action_latency_ms_p50={[r['action_latency_p50_ms'] for r in runs]} "
          f"action_latency_ms_p99={[r['action_latency_p99_ms'] for r in runs]} "
          f"calls_per_run={[c['calls'] for c in per_run]} "
          f"host_s_per_run={[c['host_s'] for c in per_run]} "
          f"decode_graph_per_run={[c['decode'] for c in per_run]} "
          f"captures_per_run={[c['decode'].get('captures', 0) for c in per_run]} "
          f"replays_per_run={[c['decode'].get('replays', 0) for c in per_run]} "
          f"cache_sets={sum(len(x) for x in inner.decode_buffers._sets.values())} "
          f"loops={len(inner.decode_buffers._loops)} "
          f"episode_steps={dict(sorted(steps.items()))} launches={launches} "
          f"plain_version_calls=0 peak_mem_gib={peak_gib:.2f} "
          f"python_hash_seed={os.environ.get('PYTHONHASHSEED')} gpu={gpu_line()!r}")
    print(f"phase evaluate: headline {json.dumps(result)}")
    del inner
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate": launches}, eval_kernel_rows(device, shapes)


# ------------------------------------------------------- evaluate server
#: the evaluate server phase: FakeEnv episodes, their step budget and frames
SERVER_EPISODES = 2
SERVER_MAX_STEP = 16
SERVER_HW = 224
SERVER_KERNELS = ("K1", "K4", "K5", "K6a", "K6b", "K7", "K8")


def phase_evaluate_server(device, ckpt: Path) -> dict:
    """The reference's client-server layout: `AgentServer` on a background
    thread of this process (so that its launch counters are read here),
    and `python scripts/torch/eval.py --config <cfg>` as a subprocess with
    use_agent_server: the vln_batched evaluator over SERVER_EPISODES
    FakeEnv episodes of data/fake_r2r (one stream, SERVER_HW frames, at
    most SERVER_MAX_STEP steps) drives an `AgentClient`, whose /agent/init
    makes the server build the "internvla_n1" agent (its defaults:
    partial_async, System-2 on a background thread) from the native int8
    checkpoint `ckpt` on the card (realtime: W8A8, int8 KV). Checks the
    subprocess's exit, result.json's episodes and finite metrics, the
    agent's device, each kernel of SERVER_KERNELS launched in the server
    and no plain version called. Prints the agent's build seconds, the
    steps it served and their actions/s (steps over the seconds from the
    first step request's start to the last one's end). Returns the
    launches of the run."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.comm.server import AgentServer

    out_dir = WORK_DIR / "evaluate_server"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    server = AgentServer("127.0.0.1", 0)
    thread = server.run(background=True)
    cfg = out_dir / "cfg.py"
    cfg.write_text(
        "from internnav_tpu_torch.configs import (AgentCfg, EnvCfg, EvalCfg, EvalDatasetCfg,\n"
        "                                         TaskCfg)\n"
        "eval_cfg = EvalCfg(\n"
        f"    agent=AgentCfg(model_name='internvla_n1', ckpt_path={str(ckpt)!r},\n"
        f"                   server_host='127.0.0.1', server_port={server.port},\n"
        "                   model_settings={'profile': 'realtime'}),\n"
        "    env=EnvCfg(env_type='fake', env_num=1,\n"
        f"               env_settings={{'rgb_resolution': [{SERVER_HW}, {SERVER_HW}],\n"
        f"                             'depth_resolution': [{SERVER_HW}, {SERVER_HW}]}}),\n"
        f"    task=TaskCfg(max_step={SERVER_MAX_STEP}),\n"
        f"    dataset=EvalDatasetCfg(base_data_dir={str(REPO / 'data' / 'fake_r2r')!r},\n"
        f"                           max_episodes={SERVER_EPISODES}),\n"
        f"    eval_type='vln_batched', output_dir={str(out_dir)!r}, use_agent_server=True)\n")
    plain, stamps = collections.Counter(), []
    init, step = server.init_agent, server.step_agent

    def timed_init(agent_config):
        t = time.perf_counter()
        try:
            return init(agent_config)
        finally:
            stamps.append(("init", t, time.perf_counter()))

    def timed_step(name, payload):
        t = time.perf_counter()
        try:
            return step(name, payload)
        finally:
            stamps.append(("step", t, time.perf_counter()))

    server.init_agent, server.step_agent = timed_init, timed_step
    spies = _plain_spies(plain)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch" / "eval.py"),
                               "--config", str(cfg)], cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        launches = launch_counts()
    finally:
        _restore(spies)
        server.shutdown()
        thread.join(timeout=30)
        for agent in server.agents.values():
            agent.close()
    (out_dir / "eval.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise AssertionError(f"evaluate server: eval.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    agent = server.agents.get("internvla_n1")
    if agent is None or agent.policy.device.type != "cuda":
        raise AssertionError(f"evaluate server: the server's agent is not on the card: {agent}")
    with open(out_dir / "result.json") as f:
        metrics = json.loads(f.read().splitlines()[-1])
    values = [v for v in metrics.values() if isinstance(v, (int, float))]
    if metrics.get("num_episodes") != SERVER_EPISODES or not np.isfinite(values).all():
        raise AssertionError(f"evaluate server: result.json {metrics}")
    missing = [k for k in SERVER_KERNELS if not launches[k]]
    if missing or plain:
        raise AssertionError(f"evaluate server: kernels {missing} never launched {launches}, "
                             f"or plain versions ran on the card: {dict(plain)}")
    steps = [(a, b) for kind, a, b in stamps if kind == "step"]
    build_s = sum(b - a for kind, a, b in stamps if kind == "init")
    serve_s = steps[-1][1] - steps[0][0]
    del server, agent
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase evaluate_server: path=evaluate_server agent=internvla_n1 ckpt=native_int8 "
          f"profile=realtime device=cuda episodes={int(metrics['num_episodes'])} "
          f"max_step={SERVER_MAX_STEP} hw={SERVER_HW} steps={len(steps)} "
          f"agent_build_s={build_s:.2f} serve_s={serve_s:.3f} "
          f"actions_per_s={len(steps) / serve_s:.3f} "
          f"step_request_s_mean={statistics.mean(b - a for a, b in steps):.4f} "
          f"eval_wall_s={wall_s:.2f} metrics={json.dumps(metrics)} launches={launches} "
          f"plain_calls=0 gpu={gpu_line()!r}")
    return {"evaluate_server": launches}


# ------------------------------------------------------- evaluate habitat
#: the evaluate habitat phase: serve realtime's 420x420 camera (R2R's
#: 640x480 does not fit `preprocess_images`' whole 28-pixel merges, in
#: either package: ROADMAP §3), the dual_system run's episodes, every
#: run's step budget (system2 and dialog: one episode each)
HABITAT_HW = 420
HABITAT_EPISODES = 2
HABITAT_MAX_STEP = 32
HABITAT_KERNELS = ("K1", "K4", "K5", "K6a", "K6b", "K7", "K8")
#: what the scripted decode returns in each run, per episode, call after
#: call (an episode's last text repeats): the branches each run must take.
#: dual_system: an action list, then STOP; pixel goals (System-1). system2:
#: pixel goals (the follower). dialog: a question (the agent's SimpleNPC
#: answers), a pixel goal (goal_gps), an action list, STOP
HABITAT_SCRIPTS = {
    "dual_system": (("↑ ↑ ← ↑", "STOP"), ("140 220",)),
    "system2": (("140 220",),),
    "dialog": (("where should I go now?", "140 220", "↑ ↑", "STOP"),),
}
#: each traj query's relative L2 gap between the unfused step's latents (a
#: re-prefill attending over bf16 K/V) and the fused step's (a chunk decode
#: over the int8 KV cache), on the same policy and frame: the bound PERF.md
#: §6 states, from the int8 cache's rounding amplified through 28 layers of
#: int8 activation codes
UNFUSED_LATENT_RTOL = 0.5
HABITAT_LEGAL = {"dual_system": {0, 1, 2, 3, 5, 6}, "system2": {0, 1, 2, 3},
                 "dialog": {0, 1, 2, 3}}


def habitat_episodes(n: int, seed: int, tag: str):
    """n seeded R2R-style planar episodes whose reference paths head along
    +x from the start (where FakeSim's agent faces), 5 segments of 0.8-1.6
    m: a pixel goal ahead snaps onto the path ahead of the agent."""
    import numpy as np

    from internnav_tpu_torch.env.episodes import Episode

    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seg = np.c_[r.uniform(0.8, 1.6, 5), r.uniform(-0.4, 0.4, 5), np.zeros(5)]
        ref = np.vstack([np.zeros(3), np.cumsum(seg, axis=0)]) + [*r.uniform(-2, 2, 2), 0.0]
        out.append(Episode(
            episode_id=f"{tag}{i}", trajectory_id=f"t{i}", scene_id="habitat_smoke",
            instruction_text=INSTRUCTION, instruction_tokens=None, start_position=ref[0],
            start_rotation=np.zeros(1), reference_path=ref,
            geodesic_distance=float(np.linalg.norm(np.diff(ref, axis=0), axis=1).sum())))
    return out


def scripted_decode(policy, scripts, cycle: bool = False):
    """Install on `policy` a tokenizer whose encode is SimpleTokenizer's and
    whose decode returns scripts[e]'s texts in turn (the last repeating, or
    all of them in a cycle with `cycle`), e the episode (advanced by each
    policy.reset()); the decode on the card still runs in full. Returns a
    function that restores the policy."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import SimpleTokenizer

    class Scripted(SimpleTokenizer):
        episode, call = -1, 0

        def decode(self, ids):
            script = scripts[max(0, min(self.episode, len(scripts) - 1))]
            self.call += 1
            if cycle:
                return script[(self.call - 1) % len(script)]
            return script[min(self.call - 1, len(script) - 1)]

    tok, reset, saved = Scripted(policy.cfg.text.vocab_size), policy.reset, policy.tokenizer
    if (tok.eos_token_id, tok.pad_token_id) != (saved.eos_token_id, saved.pad_token_id):
        raise AssertionError("the scripted tokenizer's stop and pad ids differ from the policy's")

    def next_episode():
        tok.episode, tok.call = tok.episode + 1, 0
        reset()

    policy.tokenizer, policy.reset = tok, next_episode

    def restore():
        policy.tokenizer = saved
        del policy.reset

    return restore


def _habitat_records(out_dir: Path):
    with open(out_dir / "progress.json") as f:
        return [json.loads(line) for line in f if line.strip()]


def expected_unfused_launches(cfg, steps: int, logits_steps: int) -> dict:
    """Launches of one unfused System-2 step on the realtime profile (one
    frame encoded, as a fused request's): `expected_serve_launches` of a
    request with `steps` decode steps, except that `generate_latents`'
    re-prefill (K1 a layer; K6a 4, K6b 7 on the prefill tiles and K7 1 a
    layer pass; no lm_head) stands in for the latent chunk (K5 1, K6a 4,
    K6b 4 of them 2 fused, K7 1 a layer pass)."""
    L = cfg.text.num_hidden_layers
    want = expected_serve_launches(cfg, "realtime", [steps], 1 + logits_steps, 0, 0)
    for key, delta in (("K1", L), ("K5", -L), ("K6b", 3 * L), ("K6b_fused", -2 * L)):
        want[key] += delta
    return want


def phase_evaluate_habitat(device, ckpt: Path) -> dict:
    """The Habitat VLN-CE and VL-LN dialog evaluators at 7B on the card,
    over NavmeshFakeSim at HABITAT_HW: `Evaluator.init` with the
    "internvla_n1" agent loaded from the native int8 checkpoint `ckpt`
    (realtime: W8A8, int8 KV; `habitat_dual_system_cfg.py`'s settings),
    then on its policy, each with a scripted decode (HABITAT_SCRIPTS):
    dual_system over HABITAT_EPISODES episodes of at most HABITAT_MAX_STEP
    steps (then again from its progress.json: nothing re-run); system2 over
    one (`snap_point` and `follow_toward`); `HabitatDialogEvaluator` with a
    `DialogAgent` around the policy over one, its goal_info answered by
    the agent's SimpleNPC; one System-2 request through
    `s2_step(fused=False)` against `fused=True` on the same frame (the
    policy's own tokenizer): tokens equal, each query's latents within
    UNFUSED_LATENT_RTOL. Holds the look-down capture balanced, every
    action legal, each branch taken, the metrics finite, each step's decode
    loop, and every kernel's launches equal to the counts computed from the
    System-2 / System-1 calls and the frames, with no plain version run.
    Prints seconds per System-2 and System-1 call. Returns the launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, TaskCfg
    from internnav_tpu_torch.dialog.dialog_agent import DialogAgent
    from internnav_tpu_torch.dialog.evaluator import HabitatDialogEvaluator
    from internnav_tpu_torch.evaluator import Evaluator
    from internnav_tpu_torch.habitat.sim_adapter import NavmeshFakeSim

    root = WORK_DIR / "evaluate_habitat"
    shutil.rmtree(root, ignore_errors=True)

    def cfg(mode, agent="internvla_n1", eval_type="habitat_vln"):
        return EvalCfg(agent=AgentCfg(model_name=agent, ckpt_path=str(ckpt),
                                      model_settings={"system1": "nextdit_async"}),
                       env=EnvCfg(env_type="habitat"), task=TaskCfg(max_step=HABITAT_MAX_STEP),
                       eval_type=eval_type, eval_settings={"mode": mode},
                       output_dir=str(root / mode))

    def sim():
        s = NavmeshFakeSim(rgb_hw=(HABITAT_HW, HABITAT_HW))
        s.action_log, step = [], s.step
        s.step = lambda a: s.action_log.append(int(a)) or step(a)
        return s

    t0 = time.perf_counter()
    sims = {"dual_system": sim()}
    ev = Evaluator.init(cfg("dual_system"), sim=sims["dual_system"],
                        episodes=habitat_episodes(HABITAT_EPISODES, 0, "d"))
    agent, policy = ev.agent, ev.policy
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    if policy.device.type != "cuda" or policy.cfg.text.weight_dtype != "int8" \
            or policy.cfg.text.kv_dtype != "int8" or policy.cfg.system1 != "nextdit_async":
        raise AssertionError(f"evaluate habitat: the agent's policy is {policy.cfg.text} "
                             f"{policy.cfg.system1} on {policy.device}")
    calls, s1, encodes, part = [], [], [], ["dual_system"]
    s2_step, s1_step, encode = policy.s2_step, policy.s1_step_latent, policy._encode_images

    def recorded_s2(image, instruction, look_down=False, max_new_tokens=MAX_NEW_TOKENS,
                    fused=True):
        before, t = decode_stats(), time.perf_counter()
        out = s2_step(image, instruction, look_down, max_new_tokens, fused)
        kind = ("pixel" if out.output_latent is not None else
                "stop" if 0 in out.output_action else "actions" if out.output_action else "none")
        calls.append({"part": part[0], "fused": fused, "kind": kind,
                      "s": time.perf_counter() - t, "gen": len(policy.last_gen_tokens),
                      "loop": decode_stats() - before})
        return out

    def recorded_s1(rgb, depth, latent, *args, **kwargs):
        t = time.perf_counter()
        out = s1_step(rgb, depth, latent, *args, **kwargs)
        s1.append({"part": part[0], "s": time.perf_counter() - t, "actions": len(out.idx),
                   "finite": bool(np.isfinite(out.trajectory).all())})
        return out

    def recorded_encode(images):
        encodes.append(tuple(images.shape[:3]))
        return encode(images)

    policy.s2_step, policy.s1_step_latent = recorded_s2, recorded_s1
    policy._encode_images = recorded_encode
    restore = scripted_decode(policy, HABITAT_SCRIPTS["dual_system"])
    plain, records, seconds = collections.Counter(), {}, {}
    spies = _plain_spies(plain)
    try:
        reset_launch_counts()
        t = time.perf_counter()
        metrics = ev.eval()
        seconds["dual_system"] = time.perf_counter() - t
        records["dual_system"] = _habitat_records(root / "dual_system")
        n_calls = len(calls)
        again = sim()  # the resume: every episode is in progress.json
        resumed = Evaluator.init(cfg("dual_system"), sim=again, agent=agent,
                                 episodes=habitat_episodes(HABITAT_EPISODES, 0, "d")).eval()
        if again.action_log or len(calls) != n_calls \
                or not resumed["num_episodes"] == metrics["num_episodes"] == HABITAT_EPISODES:
            raise AssertionError(f"evaluate habitat: the resume re-ran {again.action_log}, "
                                 f"{len(calls) - n_calls} System-2 calls, {resumed}")
        restore()
        part[0] = "system2"
        restore = scripted_decode(policy, HABITAT_SCRIPTS["system2"])
        sims["system2"] = sim()
        t = time.perf_counter()
        Evaluator.init(cfg("system2"), sim=sims["system2"], agent=agent,
                       episodes=habitat_episodes(1, 1, "s")).eval()
        seconds["system2"] = time.perf_counter() - t
        records["system2"] = _habitat_records(root / "system2")
        restore()
        part[0] = "dialog"
        restore = scripted_decode(policy, HABITAT_SCRIPTS["dialog"])
        sims["dialog"] = sim()
        dialog_agent = DialogAgent(AgentCfg(model_name="dialog"), policy=policy)
        outs, step = [], dialog_agent.step
        dialog_agent.step = lambda obs: outs.append(step(obs)[0]) or [outs[-1]]
        episode = habitat_episodes(1, 2, "q")[0]
        episode.extra["goal_info"] = {"object": "the second door", "room": "corridor",
                                      "nearby": ["table"]}
        t = time.perf_counter()
        records["dialog"] = HabitatDialogEvaluator(
            cfg("dialog", "dialog", "habitat_dialog"), sim=sims["dialog"], episodes=[episode],
            agent=dialog_agent).eval_action()
        seconds["dialog"] = time.perf_counter() - t
        restore()
        # unfused against fused: one request on the same frame, the policy's
        # own tokenizer (its text holds digits: the latents are made)
        part[0] = "unfused"
        rgb, _ = request_frames(np.random.default_rng(18))
        t = time.perf_counter()
        got = {}
        for fused in (True, False):
            policy.reset()
            out = policy.s2_step(rgb, INSTRUCTION, fused=fused)
            got[fused] = (policy.last_gen_tokens.copy(), out.output_latent.float())
        seconds["unfused"] = time.perf_counter() - t
        torch.cuda.synchronize(device)
        launches = launch_counts()
    finally:
        _restore(spies)
        del policy.s2_step, policy.s1_step_latent, policy._encode_images
        if "reset" in vars(policy):
            restore()
        agent.close()
    wall_s = sum(seconds.values())
    # the branches, the actions, the capture, the metrics
    kinds = {p: collections.Counter(c["kind"] for c in calls if c["part"] == p)
             for p in HABITAT_SCRIPTS}
    dual_log, s2_log, dialog_log = (sims[p].action_log for p in HABITAT_SCRIPTS)
    problems = []
    for p, want in (("dual_system", ("pixel", "actions", "stop")), ("system2", ("pixel",)),
                    ("dialog", ("pixel", "actions"))):
        problems += [f"{p}: no {k} branch" for k in want if not kinds[p][k]]
        problems += [f"{p}: illegal action {a}" for a in set(sims[p].action_log)
                     - HABITAT_LEGAL[p]]
    i = 0
    while i < len(dual_log):  # LOOKDOWN x2 then LOOKUP x2 (JAX test_habitat_contract)
        if dual_log[i] in (5, 6):
            if dual_log[i:i + 4] != [5, 5, 6, 6]:
                problems.append(f"dual_system: unbalanced capture at {i}: {dual_log[i:i + 4]}")
            i += 4
        else:
            i += 1
    if not s1 or any(c["actions"] > 4 or not c["finite"] for c in s1):
        problems.append(f"System-1 calls {s1}")
    if not (sims["system2"].follow_calls and sims["system2"].snap_calls):
        problems.append("system2: the follower was not used")
    asked = [o for o in outs if o["action"] == [4]]
    if not asked or "answer" not in asked[0] or not any("goal_gps" in o for o in outs) \
            or records["dialog"][0]["questions"] < 1:
        problems.append(f"dialog: no question answered by the NPC then a goal: {outs}")
    for p, recs in records.items():
        want_n = HABITAT_EPISODES if p == "dual_system" else 1
        values = [v for r in recs for v in r.values() if isinstance(v, (int, float))]
        if len(recs) != want_n or not np.isfinite(values).all():
            problems.append(f"{p}: records {recs}")
    # each call's decode loop, and every kernel's launches
    for c in calls:
        st, n = c["loop"], loop_steps(c["gen"])
        if st["replays"] != n or st["captures"] != 2 * st["warmup_steps"] \
                or st["steps"] != st["replays"] + st["warmup_steps"] \
                or st["logits_steps"] != n - (n == MAX_NEW_TOKENS) + st["warmup_steps"]:
            problems.append(f"decode loop {dict(st)} of a {c['gen']}-token step")
    fused = [c for c in calls if c["fused"]]
    if encodes != [(1, HABITAT_HW, HABITAT_HW)] * len(calls):
        problems.append(f"vision encodes {encodes}: one new frame a System-2 step expected")
    window_block, full_block = policy._vision_host_indices(HABITAT_HW, HABITAT_HW, 1)[1]
    if window_block or not full_block:  # expected_serve_launches' vision K1 count
        problems.append(f"vision blocks {window_block, full_block}: the K1 count assumes ragged "
                        "windows (K1 a windowed block) and one uniform image (no K1)")
    want = expected_serve_launches(policy.cfg, "realtime", [c["loop"]["steps"] for c in fused],
                                   len(fused) + sum(c["loop"]["logits_steps"] for c in fused),
                                   len(s1), dit_layers(policy))
    for c in calls:
        if not c["fused"]:
            extra = expected_unfused_launches(policy.cfg, c["loop"]["steps"],
                                              c["loop"]["logits_steps"])
            want = {k: want[k] + extra[k] for k in want}
    if launches != want:
        problems.append(f"kernel launches {launches}, expected {want}")
    if plain:
        problems.append(f"plain versions ran on the card: {dict(plain)}")
    missing = [k for k in HABITAT_KERNELS if not launches[k]]
    if missing:
        problems.append(f"kernels {missing} never launched")
    # unfused against fused
    (ft, fl), (ut, ul) = got[True], got[False]
    rel = ((fl - ul).norm(dim=-1) / ul.norm(dim=-1))[0].tolist()
    cos = torch.nn.functional.cosine_similarity(fl, ul, dim=-1)[0].tolist()
    if not np.array_equal(ft, ut):
        first = int(np.argmax(ft[:min(len(ft), len(ut))] != ut[:min(len(ft), len(ut))]))
        problems.append(f"unfused tokens differ from the fused ones from step {first} "
                        f"({len(ft)} and {len(ut)} tokens)")
    if fl.shape != ul.shape or not torch.isfinite(ul).all() or max(rel) > UNFUSED_LATENT_RTOL:
        problems.append(f"unfused latents {tuple(ul.shape)}: relative gap {rel} past "
                        f"{UNFUSED_LATENT_RTOL}")
    s2_s = {p: [round(c["s"], 4) for c in calls if c["part"] == p]
            for p in (*HABITAT_SCRIPTS, "unfused")}
    print(f"phase evaluate_habitat: path=evaluate_habitat agent=internvla_n1 ckpt=native_int8 "
          f"profile=realtime hw={HABITAT_HW} max_step={HABITAT_MAX_STEP} "
          f"agent_build_s={build_s:.2f} seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"phase_s={wall_s:.2f} s2_calls={len(calls)} s1_calls={len(s1)} "
          f"branches={json.dumps({p: dict(k) for p, k in kinds.items()})} "
          f"s2_s={json.dumps(s2_s)} s1_s={[round(c['s'], 4) for c in s1]} "
          f"s1_actions={[c['actions'] for c in s1]} "
          f"generated_tokens={[c['gen'] for c in calls]} "
          f"actions={json.dumps({p: sims[p].action_log for p in sims})} "
          f"dual_system_metrics={json.dumps(metrics)} resumed_episodes={resumed['num_episodes']} "
          f"records={json.dumps(records, default=str)} launches={launches} plain_calls={sum(plain.values())} "
          f"gpu={gpu_line()!r}")
    print(f"phase evaluate_habitat: unfused_vs_fused tokens_equal={np.array_equal(ft, ut)} "
          f"generated={len(ft)}/{len(ut)} latent_rel_gap={[round(x, 5) for x in rel]} "
          f"latent_cosine={[round(x, 5) for x in cos]} "
          f"latent_max_abs={float((fl - ul).abs().max()):.5f} "
          f"latent_max={float(ul.abs().max()):.5f} bound={UNFUSED_LATENT_RTOL} "
          f"fused_s={s2_s['unfused'][0]} unfused_s={s2_s['unfused'][1]} gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("evaluate habitat: " + "; ".join(problems))
    del ev, agent, policy, dialog_agent
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_habitat": launches}


# ------------------------------------------------------- evaluate vln_pe
#: the evaluate vln_pe phase. (a) flash: scripts/torch/eval.py's path on
#: the h1 InternVLA-N1 config, with the fake_physics backend and a square
#: camera of whole 28-pixel merges (its 640x480 is ROADMAP F21), env_num 1;
#: (b) physical: move_by_discrete over 50 substeps a macro step, the H1
#: loco actor on the card; (c) the pipelined evaluator's internutopia
#: cohorts behind VLNPEBatchAdapter
H1_CONFIG = REPO / "scripts" / "torch" / "configs" / "h1_internvla_n1_async_cfg.py"
VLNPE_HW = 420
VLNPE_EPISODES = 2
VLNPE_MAX_STEP = 32
VLNPE_PHYSICAL_STEPS = 8
VLNPE_COHORTS = 2
VLNPE_ROWS = 4
VLNPE_BATCH_HW = 224
VLNPE_BATCH_EPISODES = 8
VLNPE_BATCH_MAX_STEP = 16
VLNPE_BATCH_NEW_TOKENS = 32
VLNPE_KERNELS = ("K1", "K4", "K5", "K6a", "K6b", "K7", "K8")
#: the loco actor on the card against the same weights on the host, fp32
#: (TF32 off): 4 layers of 128-512 products summed in another order
LOCO_TOL = 1e-5
#: what the scripted decode returns. (a), per episode (an episode's last
#: text repeating): episode 0 an action list, a pixel goal (System-1),
#: then STOP; episode 1 pixel goals. (b) pixel goals. (c) the texts in a
#: cycle over every row
VLNPE_SCRIPTS = {
    "flash": (("↑ ← ↑ →", "140 220", "STOP"), ("140 220",)),
    "physical": (("140 220",),),
    "pipelined": (("100 60", "↑ ← ↑ →", "60 100", "↑ ↑ STOP"),),
}
VLNPE_LEGAL = {0, 1, 2, 3}


def expected_pipelined_launches(policy, vision, prefills: int, tails, s1_calls: int) -> dict:
    """Launches of the pipelined evaluator's System-2 and System-1 work on
    the realtime profile, from its calls: each vision call (n h x w frames:
    K1 once a ViT block whose segments are ragged, K8 once a block); each
    group's prefill (K1 a layer; per layer pass K6a 4 and K7 1, K6b 7 on
    the prefill tiles; one lm_head call: K6a PLAIN 1, K6b 1); each grouped
    tail (G cache groups of M rows in all, `steps` decode steps run on the
    device of which `logits` call the lm_head: K4 and K7 once a group and
    layer a step; K6a 4 a layer pass, K6b 7 a layer pass above
    GEMM_DECODE_MAX_M rows, else 4 with 2 fused; one K6a PLAIN and K6b a
    logits step; then the latent chunk at M x n_query rows: K5 and K7 once
    a group and layer, K6a and K6b as a step); each System-1 denoise
    (`s1_silu_launches`)."""
    from internnav_tpu_torch.ops.quant import GEMM_DECODE_MAX_M

    cfg, v = policy.cfg, policy.cfg.vision
    L = cfg.text.num_hidden_layers
    want = dict.fromkeys(LAUNCH_KEYS + ("K8",), 0)

    def add(**counts):
        for k, n in counts.items():
            want[k] += n

    def k6b(M):  # K6b launches and fused launches a layer pass of M rows
        return (7, 0) if M > GEMM_DECODE_MAX_M else (4, 2)

    for n, h, w in vision:
        window_block, full_block = policy._vision_host_indices(h, w, n)[1]
        add(K1=(0 if window_block else v.depth - len(v.fullatt_block_indexes))
            + (0 if full_block else len(v.fullatt_block_indexes)), K8=v.depth)
    add(K1=L * prefills, K6a=(4 * L + 1) * prefills, K6a_rmsnorm=2 * L * prefills,
        K6a_swiglu=L * prefills, K6a_plain=(L + 1) * prefills, K6b=(7 * L + 1) * prefills,
        K7=L * prefills)
    for G, M, steps, logits in tails:
        (dec, dec_fused), (chk, chk_fused) = k6b(M), k6b(M * cfg.n_query)
        passes = steps + 1
        add(K4=L * G * steps, K5=L * G, K7=L * G * passes, K6a=4 * L * passes + logits,
            K6a_rmsnorm=2 * L * passes, K6a_swiglu=L * passes, K6a_plain=L * passes + logits,
            K6b=L * (dec * steps + chk) + logits, K6b_fused=L * (dec_fused * steps + chk_fused))
    add(K8=s1_calls * s1_silu_launches(cfg, dit_layers(policy)))
    return want


def phase_evaluate_vln_pe(device, ckpt: Path) -> dict:
    """The VLN-PE protocol (InternUtopia physics, simulator-free through
    FakePhysicsVecEnv) at 7B on the card, the "internvla_n1" agents loaded
    from the native int8 checkpoint `ckpt` (realtime: W8A8, int8 KV), each
    part with a scripted decode (VLN_SCRIPTS):
    (a) flash: `scripts/torch/eval.py`'s main in this process on the h1
        config (`h1_internvla_n1_async_cfg.py`: partial_async, System-2 on
        its thread) with backend fake_physics and a VLNPE_HW camera,
        VLNPE_EPISODES episodes of data/fake_r2r in one env of at most
        VLNPE_MAX_STEP steps (`get_config`'s assembly, `VLNPEEvaluator`,
        `InternutopiaEnv`), then main again: the resume re-runs nothing
        and counts every episode;
    (b) physical: robot_flash False and use_loco, one episode of at most
        VLNPE_PHYSICAL_STEPS macro steps on the same policy (a new agent):
        the H1 loco actor on the card every 4th of the 50 substeps a macro
        step; each call's joint targets held against the same `LocoActor`
        on the host for the recorded observations within LOCO_TOL;
    (c) `VLNPipelinedEvaluator` with env_type internutopia: VLNPE_COHORTS
        cohorts x VLNPE_ROWS FakePhysics envs at VLNPE_BATCH_HW through
        `VLNPEBatchAdapter`, `BatchedInternVLAN1Agent` over the shared
        grouped decode of the same policy, VLNPE_BATCH_EPISODES episodes of
        at most VLNPE_BATCH_MAX_STEP steps.
    Each part: every action legal, every episode ended with finite metrics,
    K1 and K4-K8 launched exactly as computed from its calls and frames
    (`expected_serve_launches` for the single stream,
    `expected_pipelined_launches` for the cohorts), no plain version run.
    Prints the seconds of each part and of each System-2 and System-1
    call, and the loco calls a substep. Returns the phase's launches."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.agent.internvla_n1_agent import (
        BatchedInternVLAN1Agent,
        InternVLAN1Agent,
    )
    from internnav_tpu_torch.configs import (
        AgentCfg, EnvCfg, EvalCfg, MetricCfg, TaskCfg, load_py_config,
    )
    from internnav_tpu_torch.configs.vln_default import get_config
    from internnav_tpu_torch.env.internutopia import loco as loco_mod
    from internnav_tpu_torch.evaluator import Evaluator
    from internnav_tpu_torch.evaluator.vln_pipelined_evaluator import VLNPipelinedEvaluator
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

    root = WORK_DIR / "evaluate_vln_pe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    spec = importlib.util.spec_from_file_location(
        "port_eval_cli", REPO / "scripts" / "torch" / "eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    flash_cfg = root / "flash_cfg.py"
    flash_cfg.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(H1_CONFIG)!r})\n"
        "eval_cfg.env.env_settings['backend'] = 'fake_physics'\n"
        f"eval_cfg.task.camera_resolution = [{VLNPE_HW}, {VLNPE_HW}]\n"
        f"eval_cfg.task.max_step = {VLNPE_MAX_STEP}\n"
        f"eval_cfg.agent.ckpt_path = {str(ckpt)!r}\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        f"eval_cfg.dataset.max_episodes = {VLNPE_EPISODES}\n"
        f"eval_cfg.output_dir = {str(root / 'flash')!r}\n")

    state = {"part": "flash", "policy": None, "agent": None}
    calls, s1, encodes, outs = [], [], [], []
    seconds = {}

    def instrument(policy):
        s2_step, s1_step, encode = policy.s2_step, policy.s1_step_latent, policy._encode_images

        def recorded_s2(image, instruction, look_down=False, max_new_tokens=MAX_NEW_TOKENS,
                        fused=True):
            before, t = decode_stats(), time.perf_counter()
            out = s2_step(image, instruction, look_down, max_new_tokens, fused)
            kind = ("pixel" if out.output_latent is not None else
                    "stop" if 0 in out.output_action else
                    "actions" if out.output_action else "none")
            calls.append({"part": state["part"], "kind": kind, "s": time.perf_counter() - t,
                          "gen": len(policy.last_gen_tokens), "loop": decode_stats() - before})
            return out

        def recorded_s1(rgb, depth, latent, *args, **kwargs):
            t = time.perf_counter()
            out = s1_step(rgb, depth, latent, *args, **kwargs)
            s1.append({"part": state["part"], "s": time.perf_counter() - t,
                       "actions": len(out.idx), "finite": bool(np.isfinite(out.trajectory).all())})
            return out

        def recorded_encode(images):
            encodes.append((state["part"], tuple(images.shape[:3])))
            return encode(images)

        policy.s2_step, policy.s1_step_latent = recorded_s2, recorded_s1
        policy._encode_images = recorded_encode

    def recorded_agent(agent):
        step = agent.step

        def recorded(obs):
            out = step(obs)
            outs.append((state["part"], [int(o["action"][0]) for o in out]))
            return out

        agent.step = recorded
        return agent

    class HookedEvaluator:
        """eval.py's `Evaluator`, whose built evaluator gets the recording
        spies and the scripted decode before it runs; the resume run gets
        the first run's agent (no second load)."""

        @staticmethod
        def init(cfg, **kwargs):
            if state["agent"] is not None:
                kwargs.setdefault("agent", state["agent"])
            ev = Evaluator.init(cfg, **kwargs)
            if state["agent"] is None:
                state["agent"], state["policy"] = recorded_agent(ev.agent), ev.agent.policy
                instrument(state["policy"])
                state["restore"] = scripted_decode(state["policy"], VLNPE_SCRIPTS["flash"])
                # the first episode's script (this evaluator resets the agent
                # after an episode only)
                state["policy"].reset()
                reset_launch_counts()
            return ev

    plain = collections.Counter()
    spies = _plain_spies(plain)
    launches, metrics, problems = {}, {}, []
    loco_check = {}
    policy = agent = None
    try:
        # (a) flash, through eval.py's main
        cli.Evaluator = HookedEvaluator
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its metrics line
            metrics["flash"] = cli.main(["--config", str(flash_cfg)])
        seconds["flash"] = time.perf_counter() - t
        agent, policy = state["agent"], state["policy"]
        n_calls, n_outs = len(calls), len(outs)
        with contextlib.redirect_stdout(sys.stderr):
            metrics["flash_resumed"] = cli.main(["--config", str(flash_cfg)])
        agent.close()  # an in-flight System-2 request ends before the counts are read
        torch.cuda.synchronize(device)
        launches["flash"] = launch_counts()
        if len(calls) != n_calls or len(outs) != n_outs:
            problems.append(f"flash: the resume re-ran {len(calls) - n_calls} System-2 calls "
                            f"and {len(outs) - n_outs} steps")
        state["restore"]()
        if policy.device.type != "cuda" or policy.cfg.text.weight_dtype != "int8" \
                or policy.cfg.text.kv_dtype != "int8" or policy.cfg.system1 != "nextdit_async":
            raise AssertionError(f"evaluate vln_pe: the agent's policy is {policy.cfg.text} "
                                 f"{policy.cfg.system1} on {policy.device}")

        # (b) physical: the loco actor on the card
        state["part"] = "physical"
        restore = scripted_decode(policy, VLNPE_SCRIPTS["physical"])
        base = load_py_config(str(H1_CONFIG))
        base.env.env_settings.update(backend="fake_physics", use_loco=True)
        base.task.robot_flash = False
        base.task.camera_resolution = [VLNPE_HW, VLNPE_HW]
        base.task.max_step = VLNPE_PHYSICAL_STEPS
        base.agent.ckpt_path = str(ckpt)
        base.output_dir = str(root / "physical")
        cfg = get_config(base)
        agent = recorded_agent(InternVLAN1Agent.with_policy(policy, **{
            k: cfg.agent.model_settings[k] for k in ("infer_mode", "sys2_max_forward_step",
                                                     "continuous_traj", "async_s2")}))
        ev = Evaluator.init(cfg, episodes=habitat_episodes(1, 5, "v"), agent=agent)
        vec = ev.env.env
        actors = {id(c.actor): c.actor for c in vec.loco}
        recorded_loco, loco_s, ticks = [], [], [0]
        for actor in actors.values():
            fwd = actor.forward

            def loco_forward(x, _fwd=fwd, _actor=actor):
                y = _fwd(x)
                recorded_loco.append((_actor, x.clone(), y.clone()))
                return y

            actor.forward = loco_forward
        control, step = loco_mod.H1SpeedController.action_to_control, vec.step

        def timed_control(self, st, action):
            t0 = time.perf_counter()
            out = control(self, st, action)
            loco_s.append(time.perf_counter() - t0)
            return out

        def counted_step(actions):
            ticks[0] += 1
            return step(actions)

        loco_mod.H1SpeedController.action_to_control = timed_control
        vec.step = counted_step
        reset_launch_counts()
        t = time.perf_counter()
        try:
            metrics["physical"] = ev.eval()
        finally:
            loco_mod.H1SpeedController.action_to_control = control
        seconds["physical"] = time.perf_counter() - t
        agent.close()
        torch.cuda.synchronize(device)
        launches["physical"] = launch_counts()
        restore()
        devices = {str(c.device) for c in vec.loco}
        err = 0.0
        for actor in actors.values():
            host = loco_mod.LocoActor(device="cpu")
            host.load_state_dict({k: v.cpu() for k, v in actor.state_dict().items()})
            mine = [(x, y) for a, x, y in recorded_loco if a is actor]
            xs = torch.cat([x for x, _ in mine]).cpu()
            with torch.inference_mode():
                want = host(xs)
            err = max(err, float((torch.cat([y for _, y in mine]).cpu() - want).abs().max()))
        loco_check = {"calls": len(recorded_loco), "substeps": ticks[0],
                      "loco_substeps": vec.loco_calls, "devices": sorted(devices),
                      "max_abs_err": err, "control_ms_mean": 1e3 * statistics.mean(loco_s)
                      if loco_s else None}
        if devices != {"cuda:0"} or not recorded_loco or err > LOCO_TOL:
            problems.append(f"physical: the loco actor {loco_check} (bound {LOCO_TOL})")
        if sum(c.policy_calls for c in vec.loco) != len(recorded_loco):
            problems.append("physical: the actors' call counts differ from the recorded calls")

        # (c) the pipelined evaluator's internutopia cohorts
        state["part"] = "pipelined"
        restore = scripted_decode(policy, VLNPE_SCRIPTS["pipelined"], cycle=True)
        settings = {"batch_size": VLNPE_ROWS, "max_new_tokens": VLNPE_BATCH_NEW_TOKENS,
                    "num_sample_trajs": BATCH_TRAJS, "sys2_max_forward_step": 8,
                    "max_local_steps": 4, "system1": policy.cfg.system1}
        cfg = EvalCfg(
            agent=AgentCfg(model_name="internvla_n1_batched", model_settings=settings),
            env=EnvCfg(env_type="internutopia", env_num=VLNPE_ROWS,
                       env_settings={"backend": "fake_physics", "cohorts": VLNPE_COHORTS,
                                     "shared_decode": True}),
            task=TaskCfg(max_step=VLNPE_BATCH_MAX_STEP, warm_up_step=4, robot_flash=True,
                         camera_resolution=[VLNPE_BATCH_HW, VLNPE_BATCH_HW],
                         metric_config=MetricCfg(success_distance=3.0)),
            eval_type="vln_pipelined", output_dir=str(root / "pipelined"))
        bad, tails, prefills, s1_batched = [], [], [0], [0]
        spies.append(_check_outputs((BATCH_TRAJS, policy.cfg.predict_step_nums, 3), bad))
        tail, prefill = policy.grouped_tail, policy.prefill_s2
        s1_submit = BatchedN1Policy.s1_submit

        def recorded_tail(caches, first, *args, **kwargs):
            before, t0 = decode_stats(), time.perf_counter()
            out = tail(caches, first, *args, **kwargs)
            st = decode_stats() - before
            tails.append((len(caches), int(first.shape[0]), st["steps"], st["logits_steps"],
                          time.perf_counter() - t0))
            return out

        def recorded_prefill(*args, **kwargs):
            prefills[0] += 1
            return prefill(*args, **kwargs)

        def recorded_s1_submit(self, *args, **kwargs):
            s1_batched[0] += 1
            return s1_submit(self, *args, **kwargs)

        policy.grouped_tail, policy.prefill_s2 = recorded_tail, recorded_prefill
        BatchedN1Policy.s1_submit = recorded_s1_submit
        agent = BatchedInternVLAN1Agent(cfg.agent, policy=BatchedN1Policy(policy, VLNPE_ROWS,
                                                                          seed=0))
        reset_launch_counts()
        t = time.perf_counter()
        try:
            ev = VLNPipelinedEvaluator(
                cfg, episodes=habitat_episodes(VLNPE_BATCH_EPISODES, 6, "c"), agent=agent)
            metrics["pipelined"] = ev.eval()
        finally:
            BatchedN1Policy.s1_submit = s1_submit
            del policy.grouped_tail, policy.prefill_s2
        seconds["pipelined"] = time.perf_counter() - t
        torch.cuda.synchronize(device)
        launches["pipelined"] = launch_counts()
        restore()
        records = [r["info"] for r in ev.store.records()]
        if bad:
            problems.append(f"pipelined: {len(bad)} malformed agent outputs: {bad[:3]}")
        if len(records) != VLNPE_BATCH_EPISODES or len(ev._prebuilt_envs) != VLNPE_COHORTS \
                or not all(type(e).__name__ == "VLNPEBatchAdapter" for e in ev._prebuilt_envs):
            problems.append(f"pipelined: {len(records)} episodes over {ev._prebuilt_envs}")
        pipe_encodes = [shape for part, shape in encodes if part == "pipelined"]
        want = expected_pipelined_launches(policy, pipe_encodes, prefills[0],
                                           [x[:4] for x in tails], s1_batched[0])
        if launches["pipelined"] != want:
            problems.append(f"pipelined: kernel launches {launches['pipelined']}, "
                            f"expected {want}")
    finally:
        _restore(spies)
        for name in ("s2_step", "s1_step_latent", "_encode_images"):
            if policy is not None and name in vars(policy):
                delattr(policy, name)
        if policy is not None and "reset" in vars(policy):
            del policy.reset
        if agent is not None:
            agent.close()
        if state["agent"] is not None:
            state["agent"].close()
        cli.Evaluator = Evaluator
    # the single-stream parts: actions, branches, metrics, the launches
    kinds = {p: collections.Counter(c["kind"] for c in calls if c["part"] == p)
             for p in VLNPE_SCRIPTS}
    for p, want_kinds in (("flash", ("pixel", "actions")), ("physical", ("pixel",))):
        problems += [f"{p}: no {k} branch" for k in want_kinds if not kinds[p][k]]
        acts = {a for part, out in outs if part == p for a in out}
        if acts - VLNPE_LEGAL or not acts:
            problems.append(f"{p}: actions {sorted(acts)}")
        part_calls = [c for c in calls if c["part"] == p]
        part_s1 = [c for c in s1 if c["part"] == p]
        if not part_s1 or any(c["actions"] > 4 or not c["finite"] for c in part_s1):
            problems.append(f"{p}: System-1 calls {part_s1}")
        if [shape for part, shape in encodes if part == p] != \
                [(1, VLNPE_HW, VLNPE_HW)] * len(part_calls):
            problems.append(f"{p}: vision encodes, one new frame a System-2 step expected")
        for c in part_calls:
            st, n = c["loop"], loop_steps(c["gen"])
            if st["replays"] != n or st["steps"] != st["replays"] + st["warmup_steps"]:
                problems.append(f"{p}: decode loop {dict(st)} of a {c['gen']}-token step")
        want = expected_serve_launches(policy.cfg, "realtime",
                                       [c["loop"]["steps"] for c in part_calls],
                                       len(part_calls) + sum(c["loop"]["logits_steps"]
                                                             for c in part_calls),
                                       len(part_s1), dit_layers(policy))
        if launches[p] != want:
            problems.append(f"{p}: kernel launches {launches[p]}, expected {want}")
    window_block, full_block = policy._vision_host_indices(VLNPE_HW, VLNPE_HW, 1)[1]
    if window_block or not full_block:  # expected_serve_launches' vision K1 count
        problems.append(f"vision blocks {window_block, full_block}: the K1 count assumes ragged "
                        "windows (K1 a windowed block) and one uniform image (no K1)")
    if metrics["flash"].get("num_episodes") != VLNPE_EPISODES \
            or metrics["flash_resumed"].get("num_episodes") != VLNPE_EPISODES \
            or metrics["physical"].get("num_episodes") != 1 \
            or metrics["pipelined"].get("num_episodes") != VLNPE_BATCH_EPISODES:
        problems.append(f"episodes: {metrics}")
    for name, m in metrics.items():
        if not np.isfinite([v for v in m.values() if isinstance(v, (int, float))]).all():
            problems.append(f"{name}: metrics {m}")
    total = {k: sum(part[k] for part in launches.values()) for k in LAUNCH_KEYS + ("K8",)}
    missing = [k for k in VLNPE_KERNELS if not total[k]]
    if missing or total["K2"] or total["K3"]:
        problems.append(f"kernels {missing} never launched, or a backward kernel did: {total}")
    if plain:
        problems.append(f"plain versions ran on the card: {dict(plain)}")
    wall_s = sum(seconds.values())
    actions = {p: [a for part, out in outs if part == p for a in out]
               for p in ("flash", "physical")}
    s2_s = {p: [round(c["s"], 4) for c in calls if c["part"] == p] for p in VLNPE_SCRIPTS}
    s1_s = {p: [round(c["s"], 4) for c in s1 if c["part"] == p] for p in VLNPE_SCRIPTS}
    substeps = max(loco_check.get("substeps", 0), 1)
    print(f"phase evaluate_vln_pe: path=evaluate_vln_pe agent=internvla_n1 ckpt=native_int8 "
          f"profile=realtime hw={VLNPE_HW} max_step={VLNPE_MAX_STEP} "
          f"seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"phase_s={wall_s:.2f} s2_calls={ {p: len(v) for p, v in s2_s.items()} } "
          f"s1_calls={ {p: len(v) for p, v in s1_s.items()} } "
          f"branches={json.dumps({p: dict(k) for p, k in kinds.items()})} "
          f"s2_s={json.dumps(s2_s)} s1_s={json.dumps(s1_s)} "
          f"generated_tokens={[c['gen'] for c in calls]} "
          f"actions={json.dumps(actions)} "
          f"metrics={json.dumps(metrics)} gpu={gpu_line()!r}")
    print(f"phase evaluate_vln_pe: loco physical_macro_steps<={VLNPE_PHYSICAL_STEPS} "
          f"substeps={loco_check.get('substeps')} loco_substeps={loco_check.get('loco_substeps')} "
          f"actor_calls={loco_check.get('calls')} "
          f"loco_calls_per_substep={loco_check.get('loco_substeps', 0) / substeps:.4f} "
          f"actor_calls_per_substep={loco_check.get('calls', 0) / substeps:.4f} "
          f"control_ms_mean={loco_check.get('control_ms_mean')} "
          f"devices={loco_check.get('devices')} "
          f"card_vs_host_max_abs_err={loco_check.get('max_abs_err')} bound={LOCO_TOL} "
          f"gpu={gpu_line()!r}")
    print(f"phase evaluate_vln_pe: pipelined cohorts={VLNPE_COHORTS} rows={VLNPE_ROWS} "
          f"hw={VLNPE_BATCH_HW} episodes={VLNPE_BATCH_EPISODES} max_step={VLNPE_BATCH_MAX_STEP} "
          f"max_new_tokens={VLNPE_BATCH_NEW_TOKENS} vision_calls={len(pipe_encodes)} "
          f"prefills={prefills[0]} grouped_tails(G,M,steps,logits,s)="
          f"{[(g, m, st, lg, round(s_, 4)) for g, m, st, lg, s_ in tails]} "
          f"s1_calls={s1_batched[0]} actions_timed={metrics['pipelined'].get('actions_timed')} "
          f"episode_ends={dict(collections.Counter(r.get('fail_reason') for r in records))} "
          f"gpu={gpu_line()!r}")
    print(f"phase evaluate_vln_pe: launches={json.dumps(launches)} "
          f"plain_calls={sum(plain.values())}")
    if problems:
        raise AssertionError("evaluate vln_pe: " + "; ".join(problems))
    del ev, agent, policy
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_vln_pe": total}


# ---------------------------------------------------- evaluate recurrent
#: the evaluate recurrent phase: the reference's recurrent VLN baselines
#: (CMA, Seq2Seq) at their published width (ResNet-50 RGB at 224, the
#: DD-PPO ResNet-50 depth tower at 256, the bi-LSTM over 2504 x 50 GloVe-
#: sized embeddings, GRUs of 512), random weights from seed 0 written as a
#: reference-layout checkpoint and loaded through `from_pretrained`
RECURRENT_CONFIGS = {name: REPO / "scripts" / "torch" / "configs" / f"h1_{name}_cfg.py"
                     for name in ("cma", "seq2seq")}
RECURRENT_ENVS = 4
RECURRENT_EPISODES = 8
RECURRENT_MAX_STEP = 32
RECURRENT_COHORTS = 2
RECURRENT_STEP_ROWS = (4, 8)  # a step's seconds at these env counts
RECURRENT_LEGAL = {0, 1, 2, 3}
#: card against host: fp32 with TF32 off (main sets it for cuBLAS and
#: cuDNN), two ResNet-50s, the bi-LSTM over 200 tokens and the GRUs
RECURRENT_TOL = 1e-4
#: with random weights every env's features sit near one point and the
#: argmax never moves (every episode STOPs at its first step): the action
#: head is centred on the mean logits of RECURRENT_CALIBRATION random
#: inputs and widened by RECURRENT_HEAD_GAIN, so that episodes take steps
RECURRENT_CALIBRATION = 8
RECURRENT_HEAD_GAIN = 20.0


def recurrent_batch(n: int, device, seed: int, layers: int) -> dict:
    """A recurrent policy's inference batch of n envs at the published
    frame sizes: instructions of 0, 1, 17, 60 and 200 tokens in turn."""
    import torch

    g = torch.Generator().manual_seed(seed)
    tokens = torch.zeros(n, 200, dtype=torch.int32)
    for i in range(n):
        k = (0, 1, 17, 60, 200)[i % 5]
        tokens[i, :k] = torch.randint(1, 2504, (k,), generator=g)
    batch = {"observations": {"instruction": tokens,
                              "rgb": 255 * torch.rand(n, 224, 224, 3, generator=g),
                              "depth": torch.rand(n, 256, 256, 1, generator=g)},
             "rnn_states": torch.randn(n, layers, 512, generator=g),
             "prev_actions": torch.randint(0, 4, (n,), generator=g),
             "masks": (torch.arange(n) % 3 != 0).float(), "mode": "features"}
    return {k: ({f: t.to(device) for f, t in v.items()} if isinstance(v, dict) else
                v.to(device) if hasattr(v, "to") else v) for k, v in batch.items()}


def recurrent_checkpoint(name: str, device, root: Path) -> Path:
    """The policy at its default config drawn from seed 0 on the card, its
    action head centred (RECURRENT_CALIBRATION, RECURRENT_HEAD_GAIN),
    written as a reference-layout checkpoint (the keys JAX's
    convert_{name}_policy reads) to root/name/model.pth."""
    import torch

    from internnav_tpu_torch.model import get_config, get_policy
    from internnav_tpu_torch.model.weights.convert import recurrent_reference_state_dict

    pol = get_policy(name).build(get_config(name), device=device, seed=0)
    batch = recurrent_batch(RECURRENT_CALIBRATION, device, 1, pol.num_recurrent_layers())
    batch["masks"] = torch.ones_like(batch["masks"])
    logits, _, _ = pol.forward(batch)
    head = pol.net.action_head
    with torch.no_grad():
        head.bias.copy_(RECURRENT_HEAD_GAIN * (head.bias - logits.mean(0)))
        head.weight.mul_(RECURRENT_HEAD_GAIN)
    out = root / name
    out.mkdir(parents=True, exist_ok=True)
    torch.save(recurrent_reference_state_dict(pol.net), out / "model.pth")
    return out


def phase_evaluate_recurrent(device) -> dict:
    """The recurrent VLN policies (CMA, Seq2Seq) at the reference's width,
    from reference-layout checkpoints of random weights
    (`recurrent_checkpoint`):
    (a) `scripts/torch/eval.py`'s main in this process on `h1_cma_cfg.py`:
        vln_batched over FakeEnv, RECURRENT_ENVS envs with RGB 224x224 and
        depth 256x256, RECURRENT_EPISODES episodes of data/fake_r2r of at
        most RECURRENT_MAX_STEP steps, the "cma" agent loading the
        checkpoint through `from_pretrained`; then main again: the resume
        re-runs nothing;
    (b) the same on `h1_seq2seq_cfg.py`;
    (c) `VLNPipelinedEvaluator`, RECURRENT_COHORTS cohorts x
        RECURRENT_ENVS FakeEnv envs, "cma" agents sharing (a)'s policy;
    (d) card against host: one CMA and one Seq2Seq forward at 4 envs, the
        same checkpoints loaded on the host, logits, states and progress
        within RECURRENT_TOL.
    Every action legal, every episode ended with finite metrics, no
    hand-written kernel launched (K1-K10 stay 0: the policies are
    convolutions, GEMMs and cuDNN RNNs) and no plain version run. Prints
    each part's seconds, a step's seconds at RECURRENT_STEP_ROWS envs, one
    profiled step's device ms and launches, actions/s and peak memory.
    Returns the phase's launches."""
    import importlib.util
    import shutil

    import torch

    root = WORK_DIR / "evaluate_recurrent"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    spec = importlib.util.spec_from_file_location(
        "port_eval_cli", REPO / "scripts" / "torch" / "eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    torch.cuda.synchronize(device)  # the context exists before its statistics are reset
    torch.cuda.reset_peak_memory_stats(device)
    try:
        return _evaluate_recurrent(device, cli, root)
    finally:
        shutil.rmtree(root / "ckpt", ignore_errors=True)  # ~270 MB of random weights


def _evaluate_recurrent(device, cli, root: Path) -> dict:
    """phase_evaluate_recurrent's parts, from the checkpoints on."""
    import numpy as np
    import torch

    from internnav_tpu_torch.agent import recurrent_agent as ragents
    from internnav_tpu_torch.configs import load_py_config
    from internnav_tpu_torch.evaluator.vln_pipelined_evaluator import VLNPipelinedEvaluator
    from internnav_tpu_torch.model import get_config, get_policy

    t = time.perf_counter()
    ckpts = {name: recurrent_checkpoint(name, device, root / "ckpt") for name in RECURRENT_CONFIGS}
    torch.cuda.synchronize(device)
    seconds = {"checkpoints": time.perf_counter() - t}
    gc.collect()
    torch.cuda.empty_cache()

    state = {"part": None}
    steps = []  # (part, agent, n, actions, host s)
    coroutine = ragents._RecurrentAgentBase.step_coroutine

    def recorded(self, obs):
        t0 = time.perf_counter()
        out = yield from coroutine(self, obs)
        steps.append((state["part"], self, len(obs), [o["action"][0] for o in out],
                      time.perf_counter() - t0))
        return out

    plain = collections.Counter()
    spies = _plain_spies(plain)
    ragents._RecurrentAgentBase.step_coroutine = recorded
    launches, metrics, problems, policies = {}, {}, [], {}
    try:
        # (a), (b): eval.py's main on the h1 configs, then the resume
        for name, config in RECURRENT_CONFIGS.items():
            cfg_file = root / f"{name}_cfg.py"
            cfg_file.write_text(
                "from internnav_tpu_torch.configs import load_py_config\n"
                f"eval_cfg = load_py_config({str(config)!r})\n"
                "eval_cfg.env.env_settings.update(rgb_resolution=[224, 224], "
                "depth_resolution=[256, 256])\n"
                f"eval_cfg.env.env_num = {RECURRENT_ENVS}\n"
                f"eval_cfg.task.max_step = {RECURRENT_MAX_STEP}\n"
                f"eval_cfg.agent.ckpt_path = {str(ckpts[name])!r}\n"
                f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
                f"eval_cfg.dataset.max_episodes = {RECURRENT_EPISODES}\n"
                f"eval_cfg.output_dir = {str(root / name)!r}\n")
            state["part"] = name
            reset_launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):  # its metrics line
                metrics[name] = cli.main(["--config", str(cfg_file)])
            torch.cuda.synchronize(device)
            seconds[name] = time.perf_counter() - t
            launches[name] = launch_counts()
            n_steps = len(steps)
            policies[name] = next(a.policy for p, a, *_ in steps if p == name)
            state["part"] = f"{name}_resumed"
            t = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                metrics[f"{name}_resumed"] = cli.main(["--config", str(cfg_file)])
            seconds[f"{name}_resumed"] = time.perf_counter() - t
            if len(steps) != n_steps:
                problems.append(f"{name}: the resume re-ran {len(steps) - n_steps} steps")
            pol = policies[name]
            if pol.device != device or type(pol) is not get_policy(name):
                problems.append(f"{name}: the agent's policy is a {type(pol).__name__} on "
                                f"{pol.device}")

        # (c) pipelined cohorts sharing (a)'s CMA policy
        state["part"] = "pipelined"
        cfg = load_py_config(str(RECURRENT_CONFIGS["cma"]))
        cfg.eval_type = "vln_pipelined"
        cfg.env.env_num = RECURRENT_ENVS
        cfg.env.env_settings.update(rgb_resolution=[224, 224], depth_resolution=[256, 256],
                                    cohorts=RECURRENT_COHORTS)
        cfg.task.max_step = RECURRENT_MAX_STEP
        cfg.dataset.base_data_dir = str(REPO / "data" / "fake_r2r")
        cfg.dataset.max_episodes = RECURRENT_EPISODES
        cfg.output_dir = str(root / "pipelined")
        agent = ragents.CmaAgent(cfg.agent, policy=policies["cma"])
        reset_launch_counts()
        t = time.perf_counter()
        metrics["pipelined"] = VLNPipelinedEvaluator(cfg, agent=agent).eval()
        torch.cuda.synchronize(device)
        seconds["pipelined"] = time.perf_counter() - t
        launches["pipelined"] = launch_counts()
        cohort_agents = {a for p, a, *_ in steps if p == "pipelined"}
        if len(cohort_agents) != RECURRENT_COHORTS or any(
                a.policy is not policies["cma"] for a in cohort_agents):
            problems.append(f"pipelined: {len(cohort_agents)} cohort agents, not all on (a)'s "
                            "policy")
    finally:
        ragents._RecurrentAgentBase.step_coroutine = coroutine

    # a step's seconds at 4 and 8 envs, one profiled step, card against host
    reset_launch_counts()
    step_s, profiled, card_vs_host = {}, {}, {}
    for name, pol in policies.items():
        layers = pol.num_recurrent_layers()
        for n in RECURRENT_STEP_ROWS:
            batch = {**recurrent_batch(n, device, 2, layers), "mode": "inference"}
            pol.forward(batch)[0].cpu()  # warm: cuDNN picks its algorithms
            times = []
            for _ in range(5):
                t = time.perf_counter()
                pol.forward(batch)[0].cpu()
                times.append(time.perf_counter() - t)
            step_s[f"{name}_n{n}"] = statistics.median(times)
        batch = {**recurrent_batch(4, device, 2, layers), "mode": "inference"}
        profiled[name] = _profiled(lambda: pol.forward(batch))
        host = get_policy(name).from_pretrained(str(ckpts[name]), get_config(name), device="cpu")
        batch = recurrent_batch(4, device, 3, layers)
        got = pol.forward(batch)
        want = host.forward(recurrent_batch(4, "cpu", 3, layers))
        card_vs_host[name] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.isfinite(g).all() for g in got) or card_vs_host[name] > RECURRENT_TOL:
            problems.append(f"{name}: card against host {card_vs_host[name]} "
                            f"(bound {RECURRENT_TOL})")
        del host
    torch.cuda.synchronize(device)
    launches["steps"] = launch_counts()
    _restore(spies)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    for part in ("cma", "seq2seq", "pipelined"):
        acts = {a for p, _, _, out, _ in steps if p == part for a in out}
        if not acts or acts - RECURRENT_LEGAL:
            problems.append(f"{part}: actions {sorted(acts)}")
        if metrics[part].get("num_episodes") != RECURRENT_EPISODES:
            problems.append(f"{part}: {metrics[part].get('num_episodes')} episodes evaluated")
    for name in RECURRENT_CONFIGS:
        if metrics[f"{name}_resumed"].get("num_episodes") != RECURRENT_EPISODES:
            problems.append(f"{name}: the resume counts {metrics[f'{name}_resumed']}")
    for name, m in metrics.items():
        if not np.isfinite([v for v in m.values() if isinstance(v, (int, float))]).all():
            problems.append(f"{name}: metrics {m}")
    total = {k: sum(part.get(k, 0) for part in launches.values()) for k in LAUNCH_KEYS + ("K8",)}
    if any(total.values()):
        problems.append(f"a hand-written kernel launched: {total}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    per_part = {}
    for part in ("cma", "seq2seq", "pipelined"):
        part_steps = [s_ for p, _, _, _, s_ in steps if p == part]
        per_part[part] = {
            "s": round(seconds[part], 3), "steps": len(part_steps),
            "step_s_median": round(statistics.median(part_steps), 4) if part_steps else None,
            "actions_timed": metrics[part].get("actions_timed"),
            "actions_per_s": round(metrics[part].get("actions_timed", 0) / seconds[part], 3),
            "episode_steps": metrics[part].get("steps"), "success": metrics[part].get("success")}
    ckpt_mb = {name: round((p / "model.pth").stat().st_size / 2**20, 1)
               for name, p in ckpts.items()}
    print(f"phase evaluate_recurrent: path=evaluate_recurrent envs={RECURRENT_ENVS} "
          f"episodes={RECURRENT_EPISODES} max_step={RECURRENT_MAX_STEP} rgb=224 depth=256 "
          f"seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"phase_s={sum(seconds.values()):.2f} parts={json.dumps(per_part)} "
          f"ckpt_mb={json.dumps(ckpt_mb)} gpu={gpu_line()!r}")
    print(f"phase evaluate_recurrent: step_s={json.dumps({k: round(v, 4) for k, v in step_s.items()})} "
          f"profiled_step_n4={json.dumps(profiled)} "
          f"card_vs_host_max_abs_err={json.dumps(card_vs_host)} bound={RECURRENT_TOL} "
          f"peak_gib={peak_gib:.2f} launches={json.dumps(total)} "
          f"plain_calls={sum(plain.values())} gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("evaluate recurrent: " + "; ".join(problems))
    del policies, agent
    steps.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_recurrent": total}


# ------------------------------------------ train recurrent, RDP evaluate / train
#: train recurrent: a fixture LMDB of TRAIN_REC_EPISODES episodes of at
#: most TRAIN_REC_MAX_T steps at the reference's frames (RGB 224, depth
#: 256), converted by lmdb_to_store.py, then train.py: TRAIN_REC_STEPS
#: optimizer steps of CMA and of Seq2Seq at cma_cfg's batch size
TRAIN_REC_EPISODES = 8
TRAIN_REC_MAX_T = 32
TRAIN_REC_STEPS = 4
#: evaluate rdp: h1_rdp_cfg.py's vln_batched over FakeEnv, as evaluate
#: recurrent runs the h1 recurrent configs
RDP_ENVS = 4
RDP_EPISODES = 8
RDP_MAX_STEP = 32
#: card against host, one act call with the same draws: fp32, TF32 off,
#: a ViT-B/16, the depth ResNet-50, the text and cross encoders, then 20
#: CFG DDPM steps of the 3-layer denoiser (each step's ε feeds the next)
RDP_TOL = 1e-4
#: with random weights a denoised waypoint's dx sits near 0, which the
#: agent maps to STOP, and episodes end after a step or two: the seed-0
#: checkpoint's denoiser head has RDP_DX_BIAS taken off its dx ε, so that
#: every step's x0 estimate clamps to dx = +1 (0.25 m, a forward move or a
#: turn), and its stop-progress head's last bias is RDP_STOP_BIAS (the
#: sigmoid far below stop_threshold): episodes run to RDP_MAX_STEP and
#: each env refills its waypoint cache mid-episode. RDP_DX_BIAS x
#: sqrt(1 - abar_0) (0.0894) is ~18, far above |x_t| and the random
#: head's own output
RDP_DX_BIAS = 200.0
RDP_STOP_BIAS = -30.0
#: train rdp: write_synthetic_rdp_dataset at the reference's frames,
#: rdp_cfg's batch of 8, the EMA on (rdp_train_cfg sets use_ema)
TRAIN_RDP_STEPS = 4
TRAIN_RDP_BATCH = 8


def _load_script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"port_{name}_cli",
                                                  REPO / "scripts" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_cli(device, trainer_cls, argv) -> dict:
    """scripts/torch/train.py's main(argv) in this process with each
    optimizer step recorded (its wall seconds to the loss on the host, its
    metrics), then the saved policy reloaded through `from_pretrained` and
    held bitwise to the trained weights on the card. Returns the steps,
    the trainer, the reload's mismatches, the peak memory and the EMA as
    it stood before the first step (None without one)."""
    import torch

    from internnav_tpu_torch.model import get_policy

    steps, step, ema_start = [], trainer_cls.train_step, []

    def recorded(self, batch, draws=None):
        if not steps and self.ema is not None:
            ema_start.append({n: v.detach().clone() for n, v in self.ema.items()})
        t = time.perf_counter()
        m = step(self, batch, draws)
        m = {k: float(v) for k, v in m.items()}  # the host waits for the step here
        steps.append({"s": round(time.perf_counter() - t, 4), **{k: round(v, 6) for k, v in
                                                                 m.items()}, "trainer": self})
        return m

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    trainer_cls.train_step = recorded
    try:
        with contextlib.redirect_stdout(sys.stderr):  # its "final:" line
            _load_script("train").main(argv)
    finally:
        trainer_cls.train_step = step
    trainer = steps[-1].pop("trainer")
    for s in steps:
        s.pop("trainer", None)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    cfg = trainer.cfg
    final = Path(cfg.output_dir) / f"{cfg.name}_final"
    back = get_policy(cfg.model_name).from_pretrained(str(final), device=device)
    trained = trainer.policy.net.state_dict()
    mismatched = [n for n, t in back.net.state_dict().items() if not torch.equal(t, trained[n])]
    return {"steps": steps, "trainer": trainer, "mismatched": mismatched, "peak_gib": peak,
            "final": final, "ema_start": ema_start[0] if ema_start else None}


def _fixture_lmdb(path: Path, seed: int = 0) -> int:
    """TRAIN_REC_EPISODES reference-style trajectory records (msgpack-numpy,
    every other one under "episode_data") written by the port's LMDBWriter;
    returns the frames written."""
    import numpy as np

    from internnav_tpu_torch.dataset.lmdb_reader import LMDBWriter, packb

    rs = np.random.RandomState(seed)
    frames = 0
    with LMDBWriter(str(path)) as w:
        for i in range(TRAIN_REC_EPISODES):
            t = int(rs.randint(TRAIN_REC_MAX_T // 2, TRAIN_REC_MAX_T + 1))
            ep = {"rgb": rs.randint(0, 255, (t, 224, 224, 3)).astype(np.uint8),
                  "depth": rs.rand(t, 256, 256).astype(np.float32),
                  "instruction": rs.randint(1, 2504, int(rs.randint(8, 80))).astype(np.int32),
                  "actions": rs.randint(0, 4, t).astype(np.int32),
                  "progress": np.linspace(0, 1, t).astype(np.float32), "stuck": np.int32(0)}
            w.put(f"ep{i:03d}", packb({"episode_data": ep} if i % 2 else ep))
            frames += t
    return frames


def phase_train_recurrent(device) -> dict:
    """CMA / Seq2Seq training from an LMDB at the reference's width: a
    fixture LMDB (`_fixture_lmdb`) through `scripts/torch/lmdb_to_store.py`'s
    main, then `scripts/torch/train.py`'s main on cma_train_cfg.py and
    seq2seq_train_cfg.py for TRAIN_REC_STEPS steps at their batch size (2
    episodes, time-major, padded to the longer); the saved policy reloaded
    through `from_pretrained` equal to the trained weights. Every step's
    loss and grad norm finite; no hand-written kernel launched and no plain
    version run. Prints each step's seconds and loss, the grad norms and the
    peak memory. Returns the launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.dataset.traj_store import TrajStore
    from internnav_tpu_torch.trainer.cma_trainer import CMATrainer, Seq2SeqTrainer

    root = WORK_DIR / "train_recurrent"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    plain = collections.Counter()
    spies = _plain_spies(plain)
    reset_launch_counts()
    seconds, runs, problems = {}, {}, []
    try:
        t = time.perf_counter()
        frames = _fixture_lmdb(root / "lmdb")
        seconds["lmdb_write"] = time.perf_counter() - t
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            n = _load_script("lmdb_to_store").main(["--lmdb", str(root / "lmdb"),
                                                    "--out", str(root / "store.bin")])
        seconds["lmdb_to_store"] = time.perf_counter() - t
        if n != TRAIN_REC_EPISODES or len(TrajStore(str(root / "store.bin"), False)) != n:
            problems.append(f"lmdb_to_store imported {n} of {TRAIN_REC_EPISODES} episodes")
        for name, cls in (("cma", CMATrainer), ("seq2seq", Seq2SeqTrainer)):
            t = time.perf_counter()
            runs[name] = _train_cli(device, cls, [
                "--config", str(REPO / "scripts" / "torch" / "configs" / f"{name}_train_cfg.py"),
                "--store", str(root / "store.bin"), "--steps", str(TRAIN_REC_STEPS),
                "--batch-size", "2", "--output-dir", str(root / name)])
            seconds[name] = time.perf_counter() - t
        launches = launch_counts()
    finally:
        _restore(spies)
    for name, run in runs.items():
        st = run["steps"]
        if len(st) != TRAIN_REC_STEPS or not np.isfinite(
                [s[k] for s in st for k in ("loss", "grad_norm")]).all():
            problems.append(f"{name}: steps {st}")
        if run["mismatched"]:
            problems.append(f"{name}: the reloaded policy differs in {run['mismatched'][:3]}")
        if run["trainer"].policy.device != device or run["trainer"].batch_axis != 1:
            problems.append(f"{name}: trained on {run['trainer'].policy.device}")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    for name, run in runs.items():
        print(f"phase train_recurrent: path=train_recurrent model={name} "
              f"episodes={TRAIN_REC_EPISODES} frames={frames} batch=2 "
              f"steps={json.dumps(run['steps'])} peak_gib={run['peak_gib']:.2f} "
              f"reload_equal={not run['mismatched']} gpu={gpu_line()!r}")
    print(f"phase train_recurrent: seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"phase_s={sum(seconds.values()):.2f} launches={json.dumps(launches)} "
          f"plain_calls={sum(plain.values())}")
    if problems:
        raise AssertionError("train recurrent: " + "; ".join(problems))
    del runs
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_recurrent": launches}


def rdp_batch(n: int, device, seed: int) -> dict:
    """An RDP act batch of n envs at the reference's frames (80-token
    instructions, RoBERTa's pad id 1), built on the host."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.ones(n, 80, dtype=torch.int32)
    for i in range(n):
        k = (80, 40, 12, 3)[i % 4]
        ids[i, :k] = torch.randint(2, 50265, (k,), generator=g)
    obs = {"instruction": ids, "rgb": 255 * torch.rand(n, 224, 224, 3, generator=g),
           "depth": torch.rand(n, 256, 256, 1, generator=g), "imu": torch.randn(n, 3, generator=g)}
    batch = {"observations": obs, "rnn_states": torch.randn(n, 1, 512, generator=g),
             "prev_actions": 0.1 * torch.randn(n, 4, 3, generator=g),
             "masks": (torch.arange(n) % 3 != 0).float(), "mode": "act"}
    return {k: ({f: t.to(device) for f, t in v.items()} if isinstance(v, dict) else
                v.to(device) if hasattr(v, "to") else v) for k, v in batch.items()}


def phase_evaluate_rdp(device) -> dict:
    """RDP at rdp_cfg's width (RoBERTa-style text 6 x 512, CLIP ViT-B/16 at
    224, the DD-PPO depth ResNet-50 at 256, GRU 512, a 3-layer denoiser of
    512, 20 DDPM steps with CFG), seed-0 weights written as a
    reference-layout checkpoint (`convert.rdp_reference_state_dict`):
    (a) `scripts/torch/eval.py`'s main on `h1_rdp_cfg.py`: vln_batched over
        FakeEnv, RDP_ENVS envs, RDP_EPISODES episodes of at most
        RDP_MAX_STEP steps, the "rdp" agent loading the checkpoint through
        `from_pretrained` (the reference converter); then main again: the
        resume re-runs nothing;
    (b) card against host: one act call, the same checkpoint on the host,
        the same draws: trajectory, progress and stop-progress within
        RDP_TOL;
    (c) one act call's host seconds (to its trajectory on the host), its
        profiled device ms and launches.
    Every action legal, every episode ended with finite metrics, an env's
    waypoint cache refilled mid-episode (RDP_DX_BIAS, RDP_STOP_BIAS keep
    the episodes going), the agent's RNN states on the card; no
    hand-written kernel launched and no plain version run. Returns the
    launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.agent import rdp_agent
    from internnav_tpu_torch.model import get_config, get_policy
    from internnav_tpu_torch.model.weights.convert import rdp_reference_state_dict

    root = WORK_DIR / "evaluate_rdp"
    shutil.rmtree(root, ignore_errors=True)
    (root / "ckpt").mkdir(parents=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    seconds, metrics, problems, steps = {}, {}, [], []
    t = time.perf_counter()
    cfg = get_config("rdp")
    pol = get_policy("rdp").build(cfg, device=device, seed=0)
    params = sum(p.numel() for p in pol.net.parameters())
    with torch.no_grad():
        pol.net.action_dp_pred_net.head.bias[0] -= RDP_DX_BIAS
        pol.net.stop_progress_predictor.fc3.bias.fill_(RDP_STOP_BIAS)
    torch.save(rdp_reference_state_dict(pol.net), root / "ckpt" / "model.pth")
    del pol
    seconds["checkpoint"] = time.perf_counter() - t
    cfg_file = root / "rdp_cfg.py"
    cfg_file.write_text(
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(REPO / 'scripts/torch/configs/h1_rdp_cfg.py')!r})\n"
        "eval_cfg.env.env_settings.update(rgb_resolution=[224, 224], "
        "depth_resolution=[256, 256])\n"
        f"eval_cfg.env.env_num = {RDP_ENVS}\n"
        f"eval_cfg.task.max_step = {RDP_MAX_STEP}\n"
        f"eval_cfg.agent.ckpt_path = {str(root / 'ckpt' / 'model.pth')!r}\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        f"eval_cfg.dataset.max_episodes = {RDP_EPISODES}\n"
        f"eval_cfg.output_dir = {str(root / 'out')!r}\n")
    cli = _load_script("eval")
    coroutine = rdp_agent.RdpAgent.step_coroutine
    refills = []  # envs whose empty cache an act call refills after the episode's first step

    def recorded(self, obs):
        if self._caches is not None and len(self._caches) == len(obs):
            empty = [i for i, c in enumerate(self._caches) if not c]
            if empty:
                masks = self._masks.cpu()
                refills.extend(i for i in empty if masks[i] > 0)
        t0 = time.perf_counter()
        out = yield from coroutine(self, obs)
        steps.append((self, [o["action"][0] for o in out], time.perf_counter() - t0))
        return out

    plain = collections.Counter()
    spies = _plain_spies(plain)
    rdp_agent.RdpAgent.step_coroutine = recorded
    reset_launch_counts()
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            metrics["rdp"] = cli.main(["--config", str(cfg_file)])
        torch.cuda.synchronize(device)
        seconds["rdp"] = time.perf_counter() - t
        n_steps = len(steps)
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            metrics["rdp_resumed"] = cli.main(["--config", str(cfg_file)])
        seconds["rdp_resumed"] = time.perf_counter() - t
        if len(steps) != n_steps:
            problems.append(f"the resume re-ran {len(steps) - n_steps} steps")
        agent = steps[0][0]
        pol = agent.policy
        if pol.device != device or agent._states.device != device:
            problems.append(f"the agent's policy on {pol.device}, states on {agent._states.device}")
        # (b) card against host, (c) one act call
        host = get_policy("rdp").from_pretrained(str(root / "ckpt" / "model.pth"), cfg,
                                                 device="cpu")
        draws = pol.net.act_draws(RDP_ENVS, torch.Generator().manual_seed(5), "cpu")
        want = host.forward({**rdp_batch(RDP_ENVS, "cpu", 6), "draws": draws})
        t = time.perf_counter()
        got = pol.forward({**rdp_batch(RDP_ENVS, device, 6),
                           "draws": {k: v.to(device) for k, v in draws.items()}})
        got = [g.cpu() for g in got if g is not None]
        act_host_s = time.perf_counter() - t
        err = {k: float((g - w).abs().max()) for k, g, w in zip(
            ("trajectory", "rnn_states", "progress", "stop_progress"), got, want)}
        if max(err.values()) > RDP_TOL or not all(torch.isfinite(g).all() for g in got):
            problems.append(f"card against host {err} (bound {RDP_TOL})")
        del host
        batch = rdp_batch(RDP_ENVS, device, 7)
        pol.forward(batch)[0].cpu()  # warm
        times = []
        for _ in range(3):
            t = time.perf_counter()
            pol.forward(batch)[0].cpu()
            times.append(time.perf_counter() - t)
        profiled = _profiled(lambda: pol.forward(batch))
        launches = launch_counts()
    finally:
        rdp_agent.RdpAgent.step_coroutine = coroutine
        _restore(spies)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    acts = collections.Counter(a for _, out, _ in steps for a in out)
    if not acts or set(acts) - RECURRENT_LEGAL:
        problems.append(f"actions {dict(acts)}")
    if not refills:
        problems.append("no env refilled its waypoint cache mid-episode")
    for name, m in metrics.items():
        if m.get("num_episodes") != RDP_EPISODES or not np.isfinite(
                [v for v in m.values() if isinstance(v, (int, float))]).all():
            problems.append(f"{name}: metrics {m}")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    step_s = [s for _, _, s in steps]
    print(f"phase evaluate_rdp: path=evaluate_rdp envs={RDP_ENVS} episodes={RDP_EPISODES} "
          f"max_step={RDP_MAX_STEP} rgb=224 depth=256 params={params} "
          f"seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"phase_s={sum(seconds.values()):.2f} steps={len(steps)} "
          f"mid_episode_refills={len(refills)} "
          f"step_s_median={statistics.median(step_s):.4f} actions={json.dumps(dict(acts))} "
          f"actions_per_s={metrics['rdp'].get('actions_timed', 0) / seconds['rdp']:.3f} "
          f"metrics={json.dumps(metrics['rdp'])} gpu={gpu_line()!r}")
    print(f"phase evaluate_rdp: act_call_host_s={act_host_s:.4f} "
          f"act_call_host_s_median={statistics.median(times):.4f} "
          f"act_call_device={profiled} card_vs_host_max_abs_err={json.dumps(err)} "
          f"bound={RDP_TOL} peak_gib={peak_gib:.2f} launches={json.dumps(launches)} "
          f"plain_calls={sum(plain.values())} gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("evaluate rdp: " + "; ".join(problems))
    del agent, pol
    steps.clear()
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_rdp": launches}


def phase_train_rdp(device) -> dict:
    """RDP training at rdp_cfg's width: `write_synthetic_rdp_dataset` at the
    reference's frames (RGB 224, depth 256), then `scripts/torch/train.py`'s
    main on rdp_train_cfg.py for TRAIN_RDP_STEPS steps of TRAIN_RDP_BATCH
    samples, the EMA on; the saved policy reloaded equal to the trained
    weights, every loss term finite, the EMA moved off its start. No
    hand-written kernel launched and no plain version run. Prints each
    step's seconds and losses, the grad norms and the peak memory. Returns
    the launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.dataset.rdp_dataset import write_synthetic_rdp_dataset
    from internnav_tpu_torch.trainer.rdp_trainer import RDPTrainer

    root = WORK_DIR / "train_rdp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    plain = collections.Counter()
    spies = _plain_spies(plain)
    reset_launch_counts()
    problems = []
    try:
        t = time.perf_counter()
        write_synthetic_rdp_dataset(str(root / "store.bin"), n_episodes=4, T=16, hw=224,
                                    depth_hw=256)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        run = _train_cli(device, RDPTrainer, [
            "--config", str(REPO / "scripts" / "torch" / "configs" / "rdp_train_cfg.py"),
            "--store", str(root / "store.bin"), "--steps", str(TRAIN_RDP_STEPS),
            "--batch-size", str(TRAIN_RDP_BATCH), "--output-dir", str(root / "out")])
        train_s = time.perf_counter() - t
        launches = launch_counts()
    finally:
        _restore(spies)
    st, trainer = run["steps"], run["trainer"]
    keys = ("loss", "diffusion_loss", "progress_loss", "stop_loss", "grad_norm")
    if len(st) != TRAIN_RDP_STEPS or not np.isfinite([s[k] for s in st for k in keys]).all():
        problems.append(f"steps {st}")
    if run["mismatched"]:
        problems.append(f"the reloaded policy differs in {run['mismatched'][:3]}")
    ema, ema_start = trainer.ema, run["ema_start"]
    ema_moved = ema is not None and any(not torch.equal(ema[n], ema_start[n]) for n in ema)
    ema_lags = ema is not None and any(not torch.equal(ema[n], p)
                                       for n, p in trainer.optimizer.params)
    if not (trainer.cfg.il.use_ema and ema_moved and ema_lags):
        problems.append(f"the EMA is off, never moved off its start ({not ema_moved}) or "
                        f"equals the parameters ({not ema_lags})")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    print(f"phase train_rdp: path=train_rdp batch={TRAIN_RDP_BATCH} rgb=224 depth=256 "
          f"ema={trainer.cfg.il.use_ema} steps={json.dumps(st)} peak_gib={run['peak_gib']:.2f} "
          f"reload_equal={not run['mismatched']} write_s={write_s:.2f} train_s={train_s:.2f} "
          f"launches={json.dumps(launches)} plain_calls={sum(plain.values())} "
          f"gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("train rdp: " + "; ".join(problems))
    del run, trainer
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_rdp": launches}


# ------------------------------------------------------ standalone navdp
#: evaluate navdp_vn: the "navdp" agent on navdp_cfg (224 x 224 RGB-D,
#: memory 8, predict 24, an 8-layer decoder at 384 with 8 heads, four
#: ViT-S towers; 16 samples a replan, a replan every 4 steps) through the
#: VN pointgoal evaluator: one open episode and NAVDP_VN_CLUTTERED
#: cluttered ones of at most NAVDP_VN_MAX_STEP steps
NAVDP_VN_CLUTTERED = 2
NAVDP_VN_MAX_STEP = 16
NAVDP_VN_SAMPLES = 16
#: card against host, one replan with the same draws: fp32, TF32 off; two
#: ViT-S towers over 8 frames, 10 DDPM steps of the 8-layer decoder over
#: 16 samples, the critic, each product summed in another order by cuBLAS
#: and by the CPU
NAVDP_VN_TOL = 1e-4
#: train navdp: navdp_train_cfg.py's batch of 16 over a synthetic store of
#: 224 x 224 RGB-D random walks, the EMA on (the config sets use_ema)
TRAIN_NAVDP_STEPS = 4
TRAIN_NAVDP_BATCH = 16
#: dpt: DepthAnythingV2 (ViT-S trunk, DPT head) at the reference's 518 x
#: 518, card against host within DPT_TOL of max_depth (fp32, TF32 off)
DPT_HW = 518
DPT_TOL = 1e-4


def phase_evaluate_navdp_vn(device) -> dict:
    """Standalone NavDP at navdp_cfg's width, seed-0 weights written as a
    reference-layout checkpoint (`convert.navdp_reference_state_dict`):
    (a) `VNPointGoalEvaluator` with the "navdp" agent (`Agent.init`,
        loading the checkpoint through `from_pretrained` and the reference
        converter) over one open and NAVDP_VN_CLUTTERED cluttered pointgoal
        episodes, each replan's host seconds recorded;
    (b) card against host: one replan (pointgoal, NAVDP_VN_SAMPLES samples)
        of the same checkpoint on the host with the same draws: the best
        and worst trajectories within NAVDP_VN_TOL;
    (c) one replan's host ms (to its trajectories on the host; median of
        3 after a warm call), its profiled device ms and launches.
    Every waypoint finite, every episode evaluated with finite metrics, the
    policy on the card; no hand-written kernel launched and no plain
    version run. Prints the peak memory. Returns the launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.agent import navdp_agent
    from internnav_tpu_torch.agent.base import Agent
    from internnav_tpu_torch.configs import AgentCfg, EnvCfg, EvalCfg, TaskCfg
    from internnav_tpu_torch.evaluator import vn_evaluator as vn
    from internnav_tpu_torch.model import get_config, get_policy
    from internnav_tpu_torch.model.weights.convert import navdp_reference_state_dict

    root = WORK_DIR / "evaluate_navdp_vn"
    shutil.rmtree(root, ignore_errors=True)
    (root / "ckpt").mkdir(parents=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    seconds, problems, replans, waypoints = {}, [], [], []
    t = time.perf_counter()
    cfg = get_config("navdp")
    pol = get_policy("navdp").build(cfg, device=device, seed=0)
    params = sum(p.numel() for p in pol.net.parameters())
    ckpt = root / "ckpt" / "navdp.pth"
    torch.save(navdp_reference_state_dict(pol.net), ckpt)
    del pol
    seconds["checkpoint"] = time.perf_counter() - t
    replan = navdp_agent.NavDPAgent._replan

    def recorded(self, o):
        t0 = time.perf_counter()
        best = replan(self, o)
        replans.append(time.perf_counter() - t0)
        return best

    plain = collections.Counter()
    spies = _plain_spies(plain)
    navdp_agent.NavDPAgent._replan = recorded
    reset_launch_counts()
    try:
        t = time.perf_counter()
        agent = Agent.init(AgentCfg(model_name="navdp", ckpt_path=str(ckpt), model_settings={
            "image_size": 224, "sample_num": NAVDP_VN_SAMPLES, "replan_every": 4, "seed": 0}))
        seconds["agent_load"] = time.perf_counter() - t
        step = agent.step

        def checked(obs):
            out = step(obs)
            waypoints.append(out[0]["waypoint"])
            return out

        agent.step = checked
        eps = [vn.VNEpisode(episode_id="open", start_xy=np.asarray([0.5, 3.0]),
                            goal_xy=np.asarray([4.0, 3.0]), geodesic=3.5),
               *vn.make_cluttered_episodes(n=NAVDP_VN_CLUTTERED, seed=0)]
        eval_cfg = EvalCfg(agent=AgentCfg(model_name="navdp"),
                           env=EnvCfg(env_type="fake",
                                      env_settings={"rgb_resolution": [224, 224]}),
                           task=TaskCfg(max_step=NAVDP_VN_MAX_STEP), eval_type="vn_pointgoal",
                           output_dir=str(root / "out"))
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            metrics = vn.VNPointGoalEvaluator(eval_cfg, episodes=eps, agent=agent).eval()
        torch.cuda.synchronize(device)
        seconds["evaluate"] = time.perf_counter() - t
        pol = agent.policy
        if pol.device != device:
            problems.append(f"the agent's policy on {pol.device}")
        # (b) card against host, (c) one replan
        host = get_policy("navdp").from_pretrained(str(ckpt), cfg, device="cpu")
        g = torch.Generator().manual_seed(3)
        obs = {"input_images": torch.rand(1, 8, 224, 224, 3, generator=g),
               "input_depths": 5.0 * torch.rand(1, 8, 224, 224, 1, generator=g),
               "goal_point": torch.tensor([[2.0, 0.5, 0.0]])}
        draws = host.net.infer_draws(NAVDP_VN_SAMPLES, g, "cpu")
        batch = {"mode": "pointgoal", "observations": obs, "sample_num": NAVDP_VN_SAMPLES}
        want = host.forward({**batch, "draws": draws})
        card = {**batch, "observations": {k: v.to(device) for k, v in obs.items()},
                "draws": {k: v.to(device) for k, v in draws.items()}}
        got = [x.cpu() for x in pol.forward(card)]
        err = {k: float((g_ - w).abs().max()) for k, g_, w in zip(("worst", "best"), got, want)}
        if max(err.values()) > NAVDP_VN_TOL or not all(torch.isfinite(x).all() for x in got):
            problems.append(f"card against host {err} (bound {NAVDP_VN_TOL})")
        del host
        times = []
        for _ in range(4):  # a warm call, then 3 timed
            t = time.perf_counter()
            pol.forward(card)[1].cpu()
            times.append(time.perf_counter() - t)
        profiled = _profiled(lambda: pol.forward(card))
        launches = launch_counts()
    finally:
        navdp_agent.NavDPAgent._replan = replan
        _restore(spies)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    if not replans or not np.isfinite(np.asarray(waypoints, np.float64)).all():
        problems.append(f"{len(replans)} replans, waypoints finite: "
                        f"{bool(np.isfinite(np.asarray(waypoints, np.float64)).all())}")
    if metrics.get("num_episodes") != 1 + NAVDP_VN_CLUTTERED or not np.isfinite(
            [v for v in metrics.values() if isinstance(v, (int, float))]).all():
        problems.append(f"metrics {metrics}")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    print(f"phase evaluate_navdp_vn: path=evaluate_navdp_vn rgbd=224 memory=8 predict=24 "
          f"decoder_layers=8 samples={NAVDP_VN_SAMPLES} episodes={1 + NAVDP_VN_CLUTTERED} "
          f"max_step={NAVDP_VN_MAX_STEP} params={params} "
          f"seconds={json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"steps={len(waypoints)} replans={len(replans)} "
          f"replan_s_median={statistics.median(replans):.4f} "
          f"metrics={json.dumps(metrics)} gpu={gpu_line()!r}")
    print(f"phase evaluate_navdp_vn: "
          f"replan_host_ms_median={1e3 * statistics.median(times[1:]):.2f} "
          f"replan_host_ms={json.dumps([round(1e3 * x, 2) for x in times[1:]])} "
          f"replan_device={profiled} card_vs_host_max_abs_err={json.dumps(err)} "
          f"bound={NAVDP_VN_TOL} peak_gib={peak_gib:.2f} launches={json.dumps(launches)} "
          f"plain_calls={sum(plain.values())} gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("evaluate navdp_vn: " + "; ".join(problems))
    del agent, pol
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"evaluate_navdp_vn": launches}


def phase_train_navdp(device) -> dict:
    """NavDP training at navdp_cfg's width: `write_synthetic_navdp_dataset`
    at 224 x 224, then `scripts/torch/train.py`'s main on
    navdp_train_cfg.py for TRAIN_NAVDP_STEPS steps of TRAIN_NAVDP_BATCH
    samples, the EMA on; the saved policy reloaded equal to the trained
    weights, every loss term finite, the EMA moved off its start. No
    hand-written kernel launched and no plain version run. Prints each
    step's seconds and loss terms, and the peak memory. Returns the
    launches."""
    import shutil

    import numpy as np
    import torch

    from internnav_tpu_torch.dataset.navdp_dataset import write_synthetic_navdp_dataset
    from internnav_tpu_torch.trainer.navdp_trainer import NavDPTrainer

    root = WORK_DIR / "train_navdp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    plain = collections.Counter()
    spies = _plain_spies(plain)
    reset_launch_counts()
    problems = []
    try:
        t = time.perf_counter()
        write_synthetic_navdp_dataset(str(root / "store.bin"), n_episodes=8, T=16, hw=224)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        run = _train_cli(device, NavDPTrainer, [
            "--config", str(REPO / "scripts" / "torch" / "configs" / "navdp_train_cfg.py"),
            "--store", str(root / "store.bin"), "--steps", str(TRAIN_NAVDP_STEPS),
            "--batch-size", str(TRAIN_NAVDP_BATCH), "--output-dir", str(root / "out")])
        train_s = time.perf_counter() - t
        launches = launch_counts()
    finally:
        _restore(spies)
    st, trainer = run["steps"], run["trainer"]
    keys = ("loss", "ng_action_loss", "mg_action_loss", "critic_loss", "aux_loss", "grad_norm")
    if len(st) != TRAIN_NAVDP_STEPS or not np.isfinite([s[k] for s in st for k in keys]).all():
        problems.append(f"steps {st}")
    if run["mismatched"]:
        problems.append(f"the reloaded policy differs in {run['mismatched'][:3]}")
    ema, ema_start = trainer.ema, run["ema_start"]
    ema_moved = ema is not None and any(not torch.equal(ema[n], ema_start[n]) for n in ema)
    ema_lags = ema is not None and any(not torch.equal(ema[n], p)
                                       for n, p in trainer.optimizer.params)
    if not (trainer.cfg.il.use_ema and ema_moved and ema_lags):
        problems.append(f"the EMA is off, never moved off its start ({not ema_moved}) or "
                        f"equals the parameters ({not ema_lags})")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    print(f"phase train_navdp: path=train_navdp batch={TRAIN_NAVDP_BATCH} rgbd=224 memory=8 "
          f"ema={trainer.cfg.il.use_ema} steps={json.dumps(st)} peak_gib={run['peak_gib']:.2f} "
          f"reload_equal={not run['mismatched']} write_s={write_s:.2f} train_s={train_s:.2f} "
          f"launches={json.dumps(launches)} plain_calls={sum(plain.values())} "
          f"gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("train navdp: " + "; ".join(problems))
    del run, trainer
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_navdp": launches}


def phase_dpt(device) -> dict:
    """DepthAnythingV2 at the reference's DPT_HW x DPT_HW: seed-0 weights
    written as a reference-layout state dict
    (`convert.depth_anything_reference_state_dict`) and read back through
    `convert_depth_anything_v2` into a module on the card and one on the
    host; one forward of the same ImageNet-normalized pixels on each,
    within DPT_TOL of max_depth. Prints the card forward's host ms (median
    of 3 after a warm call), its profiled device ms and launches, and the
    peak memory. No hand-written kernel launched and no plain version run.
    Returns the launches."""
    import numpy as np
    import torch

    from internnav_tpu_torch.model.encoder.dpt import DepthAnythingV2
    from internnav_tpu_torch.model.weights.convert import (
        convert_depth_anything_v2,
        depth_anything_reference_state_dict,
    )

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    plain = collections.Counter()
    spies = _plain_spies(plain)
    reset_launch_counts()
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            seed0 = DepthAnythingV2(image_hw=DPT_HW)
        sd = depth_anything_reference_state_dict(seed0)
        host, card = DepthAnythingV2(image_hw=DPT_HW).eval(), DepthAnythingV2(image_hw=DPT_HW)
        for m in (host, card):
            m.load_state_dict(convert_depth_anything_v2(sd, m))
        card = card.eval().to(device)
        x = torch.randn(1, DPT_HW, DPT_HW, 3, generator=torch.Generator().manual_seed(1))
        xd = x.to(device)
        with torch.no_grad():
            want = host(x)
            got = card(xd).cpu()
            times = []
            for _ in range(4):  # a warm call, then 3 timed
                t = time.perf_counter()
                card(xd).cpu()
                times.append(time.perf_counter() - t)
            profiled = _profiled(lambda: card(xd))
        launches = launch_counts()
    finally:
        _restore(spies)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    err = float((got - want).abs().max())
    problems = []
    if got.shape != (1, DPT_HW, DPT_HW) or not torch.isfinite(got).all() or \
            err > DPT_TOL * card.max_depth:
        problems.append(f"card against host {err} (bound {DPT_TOL * card.max_depth}), "
                        f"shape {tuple(got.shape)}")
    if any(launches.values()):
        problems.append(f"a hand-written kernel launched: {launches}")
    if plain:
        problems.append(f"plain versions ran: {dict(plain)}")
    print(f"phase dpt: path=dpt hw={DPT_HW} params={sum(p.numel() for p in card.parameters())} "
          f"forward_host_ms_median={1e3 * statistics.median(times[1:]):.2f} "
          f"forward_device={profiled} card_vs_host_max_abs_err={err:.3e} "
          f"bound={DPT_TOL * card.max_depth} depth_range=[{float(got.min()):.4f}, "
          f"{float(got.max()):.4f}] peak_gib={peak_gib:.2f} launches={json.dumps(launches)} "
          f"plain_calls={sum(plain.values())} gpu={gpu_line()!r}")
    if problems:
        raise AssertionError("dpt: " + "; ".join(problems))
    del host, card
    gc.collect()
    torch.cuda.empty_cache()
    return {"dpt": launches}


# ----------------------------------------------------------------- navdp
#: the NavDP head on the card against the same module on the host, both
#: fp32: 20 DDPM steps of a 16-layer decoder, two ViT-S towers and the
#: former, each product summed in another order by cuBLAS and by the CPU.
#: 8.2e-6 was read on an H100; the phase also prints the same call with
#: TF32 let into the towers' convolutions and into the products, which
#: this limit is meant to catch
NAVDP_TOL = 1e-4
#: grouped against per-cohort System-1: the same draws and inputs, cuBLAS
#: at 48 streams' rows against 12 streams' (2.3e-5 read on an H100)
NAVDP_GROUPED_TOL = 1e-4
NAVDP_REQUESTS = 4


def profile_call(fn):
    """One fn() call under torch.profiler: (its device kernels' summed
    milliseconds, their launches), or None when the trace holds no device
    time (the profiler cannot trace the card here). Only the device is
    traced: host events cost seconds a call at ~14,000 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy_us += getattr(e, "self_device_time_total", 0.0) or getattr(
                e, "self_cuda_time_total", 0.0)
            launches += e.count
    return (busy_us / 1e3, launches) if busy_us > 0 else None


def _profiled(fn) -> str:
    got = profile_call(fn)
    return "not_measured(no device time in the trace)" if got is None else \
        f"{got[0]:.4f}ms/{got[1]}launches"


def phase_serve_navdp(device):
    """The 7B `navdp_async` policy in the realtime profile (W8A8, int8 KV;
    random weights from seed 0), served through the real-robot HTTP server:
    NAVDP_REQUESTS /eval_dual requests with depth at 420 x 420 (System-1's
    frames fitted to 224; the agent re-plans System-2 every request and
    runs System-1 whenever its action queue is empty, at least once),
    each trajectory finite, K1 and K4-K8 held to
    `expected_serve_launches` (no SiLU in the NavDP head), no plain
    version of a kernel run. Prints each request's and each NavDP S1
    call's seconds. Returns (the policy, the launches by path)."""
    import numpy as np
    import torch

    from internnav_tpu_torch.realworld import serve

    t0 = time.perf_counter()
    policy = serve.build_policy("realtime", device=device, system1="navdp_async")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not hasattr(policy.model, "navdp") or hasattr(policy.model, "traj_dit"):
        raise AssertionError("serve navdp: the policy has no NavDP head, or a NextDiT")
    head_params = sum(p.numel() for p in policy.model.navdp.parameters())
    head_dtypes = sorted({str(p.dtype) for p in policy.model.navdp.parameters()})
    s1_s, s1_call = [], policy.s1_step_latent

    def timed_s1(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = s1_call(*a, **kw)  # ends in the trajectory's copy to the host
        s1_s.append(time.perf_counter() - t)
        if not np.isfinite(out.trajectory).all():
            raise AssertionError("serve navdp: a non-finite trajectory")
        return out

    policy.s1_step_latent = timed_s1
    plain = collections.Counter()
    spies = _plain_spies(plain)
    try:
        by_path = phase_serve(device, "realtime", policy, build_s, label="serve_navdp",
                              requests=NAVDP_REQUESTS, long_request=False)
    finally:
        _restore(spies)
        # phase_serve's counters and recorders go; the policy serves on
        for name in ("s2_step", "s1_step_latent"):
            policy.__dict__.pop(name, None)
        for name in ("forward", "decode_chunk_grouped"):
            policy.model.language_model.__dict__.pop(name, None)
    if plain:
        raise AssertionError(f"serve navdp: plain versions ran on the card: {dict(plain)}")
    if not s1_s:  # the agent runs System-1 when its action queue is empty
        raise AssertionError(f"serve navdp: no System-1 call in {NAVDP_REQUESTS} requests")
    print(f"phase serve: path=serve_navdp system1=navdp_async head_params={head_params} "
          f"head_dtypes={head_dtypes} s1_calls={len(s1_s)} "
          f"s1_call_s={[round(x, 4) for x in s1_s]} plain_version_calls=0 gpu={gpu_line()!r}")
    return policy, by_path


def phase_navdp_card_vs_host(device, policy) -> dict:
    """One NavDP System-1 call (1 stream, BATCH_TRAJS samples, 224 x 224
    RGBD pair, injected x_init and step noises) through the card's head and
    through the same module's copy on the host, both fp32: the largest
    absolute difference held to NAVDP_TOL. cuDNN's TF32 is left at
    PyTorch's default (on) here, so that the head's own guard is what keeps
    the towers' convolutions fp32. Two control readings of the same call
    follow, neither held to a limit: the guard taken out (TF32
    convolutions), and TF32 products. Prints the card call's host seconds
    and its profiled device time and launches."""
    import contextlib
    import copy

    import torch

    from internnav_tpu_torch.model.encoder import navdp_backbone

    head = policy.model.navdp
    host = copy.deepcopy(head).cpu()
    g = torch.Generator().manual_seed(0)
    hw = policy.model.s1_image_hw
    lat = (0.5 * torch.randn(1, N_QUERY, policy.cfg.text.hidden_size, generator=g)).to(
        torch.bfloat16)
    rgb = torch.randint(0, 256, (1, 2, hw, hw, 3), generator=g, dtype=torch.uint8)
    depth = 5.0 * torch.rand(1, 2, hw, hw, 1, generator=g)
    P = policy.cfg.predict_step_nums
    x0 = torch.randn(BATCH_TRAJS, P, 3, generator=g)
    zs = torch.randn(head.denoise_steps, BATCH_TRAJS, P, 3, generator=g)
    args = [t.to(device) for t in (lat, rgb, depth, x0, zs)]

    def card():
        return head.predict_pointgoal_action_async(
            args[0], args[1].float() / 255.0, args[2], x_init=args[3], step_noises=args[4])

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    guard = navdp_backbone._fp32_convolutions
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        with torch.inference_mode():
            card()  # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = card()
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            prof = _profiled(card)
            navdp_backbone._fp32_convolutions = contextlib.nullcontext
            tf32_conv = card().cpu()
            navdp_backbone._fp32_convolutions = guard
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32_matmul = card().cpu()
            t = time.perf_counter()
            ref = host.predict_pointgoal_action_async(lat, rgb.float() / 255.0, depth,
                                                      x_init=x0, step_noises=zs)
            host_s = time.perf_counter() - t
    finally:
        navdp_backbone._fp32_convolutions = guard
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    got = got.cpu()
    err = (got - ref).abs().max().item()
    if got.shape != ref.shape or not torch.isfinite(got).all() or not err <= NAVDP_TOL:
        raise AssertionError(f"navdp card vs host: {tuple(got.shape)} max_abs_err {err} "
                             f"(tolerance {NAVDP_TOL})")
    controls = {name: (out - ref).abs().max().item()
                for name, out in (("tf32_convolutions", tf32_conv), ("tf32_products", tf32_matmul))}
    print(f"phase navdp: card_vs_host streams=1 samples={BATCH_TRAJS} hw={hw} "
          f"steps={head.denoise_steps} cudnn.allow_tf32=True max_abs_err={err} "
          f"tol={NAVDP_TOL} traj_max_abs={ref.abs().max().item():.4f} card_call_s={card_s:.4f} "
          f"card_call_profiled={prof} host_call_s={host_s:.2f} "
          f"bitwise={torch.equal(got, ref)} control_max_abs_err={controls} "
          f"controls_over_tol={ {k: v > NAVDP_TOL for k, v in controls.items()} } "
          f"gpu={gpu_line()!r}")
    return {"max_abs_err": err, "card_s": card_s}


def phase_serve_batched_navdp(device, policy) -> dict:
    """PipelinedN1Server over the NavDP policy: BATCH_COHORTS cohorts of
    BATCH_ROWS streams, 224 x 224 frames and RGBD pairs, histories
    saturated at 9 frames, the shared grouped decode of BATCH_NEW_TOKENS
    tokens (stop id -7), BATCH_S1_CALLS System-1 calls a cycle through the
    shared grouped System-1 (`s1_grouped_dispatch`: one denoise of the 48
    streams). A warm cycle; then one checked cycle with every launch held
    to `expected_batched_launches`, its grouped calls timed; then the same
    cycle with per-cohort System-1: trajectories within NAVDP_GROUPED_TOL,
    action differences counted. Returns the checked cycle's launches."""
    import numpy as np
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1 import serving

    policy.tokenizer.eos_token_id = -7  # no token: the full decode budget
    cfg = policy.cfg
    server = serving.PipelinedN1Server(policy, BATCH_ROWS, cohorts=BATCH_COHORTS)
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 256, (BATCH_COHORTS, BATCH_ROWS, 8, BATCH_HW, BATCH_HW, 3),
                        dtype=np.uint8)
    s2_frames = rng.integers(0, 256, (BATCH_COHORTS, BATCH_ROWS, BATCH_HW, BATCH_HW, 3),
                             dtype=np.uint8)
    s1_rgb = rng.integers(0, 256, (BATCH_COHORTS, BATCH_S1_CALLS, BATCH_ROWS, 2, BATCH_HW,
                                   BATCH_HW, 3), dtype=np.uint8)
    s1_depth = rng.uniform(0.0, 5.0, (BATCH_COHORTS, BATCH_S1_CALLS, BATCH_ROWS, 2, BATCH_HW,
                                      BATCH_HW, 1)).astype(np.float32)

    def frames(ci, t, ph):
        return s2_frames[ci] if ph == 0 else (s1_rgb[ci, ph - 1], s1_depth[ci, ph - 1])

    def saturate():
        for ci, pol in enumerate(server.cohorts):
            pol.reset([own_instruction(ci, r) for r in range(BATCH_ROWS)])
            pol._generator.manual_seed(pol.seed)
            for r, s in enumerate(pol.slots):
                s.rgb_list = list(hist[ci, r])
                s.episode_idx = 8

    def stream(shared_s1, host_stats=None):
        out = {}
        server.serve_stream(frames, 1, max_new_tokens=BATCH_NEW_TOKENS,
                            num_sample_trajs=BATCH_TRAJS, s1_calls=BATCH_S1_CALLS,
                            shared_decode=True, shared_s1=shared_s1, host_stats=host_stats,
                            on_cycle=lambda ci, t, s2, s1: out.setdefault(ci, (s2, s1)))
        return out

    grouped_s, warm_calls, profiled, dispatch = [], [], [], serving.s1_grouped_dispatch

    def timed_dispatch(specs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        dispatch(specs)
        end.record()
        end.synchronize()
        grouped_s.append((time.perf_counter() - t, start.elapsed_time(end) / 1e3,
                          sum(s["Bp"] for s in specs if s is not None)))

    def profiled_dispatch(specs):  # the warm cycle's last call, under the profiler
        warm_calls.append(1)
        if len(warm_calls) == BATCH_S1_CALLS:
            profiled.append(_profiled(lambda: dispatch(specs)))
        else:
            dispatch(specs)

    saturate()
    serving.s1_grouped_dispatch = profiled_dispatch
    try:
        t = time.perf_counter()
        stream(True)  # the decode loop's captures
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
    finally:
        serving.s1_grouped_dispatch = dispatch
    saturate()
    serving.s1_grouped_dispatch = timed_dispatch
    host_stats = {}
    try:
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t = time.perf_counter()
        grouped = stream(True, host_stats)
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        serving.s1_grouped_dispatch = dispatch
    saturate()
    t = time.perf_counter()
    per_cohort = stream(False)
    torch.cuda.synchronize()
    per_cohort_s = time.perf_counter() - t
    want = expected_batched_launches(policy, 1, BATCH_COHORTS, BATCH_ROWS)
    if launches != want:
        raise AssertionError(f"serve batched navdp: kernel launches {launches}, expected {want}")
    err, actions, differ = 0.0, 0, 0
    for ci in range(BATCH_COHORTS):
        (gs2, gs1), (ps2, ps1) = grouped[ci], per_cohort[ci]
        if [o.output_latent is None for o in gs2] != [False] * BATCH_ROWS or \
                len(gs1) != BATCH_S1_CALLS:
            raise AssertionError(f"serve batched navdp: cohort {ci} malformed outputs")
        for gcall, pcall in zip(gs1, ps1):
            for go, po in zip(gcall, pcall):
                if go.trajectory.shape != (BATCH_TRAJS, cfg.predict_step_nums, 3) \
                        or not np.isfinite(go.trajectory).all():
                    raise AssertionError(f"serve batched navdp: trajectory {go.trajectory.shape}"
                                         " not finite / well formed")
                err = max(err, float(np.abs(go.trajectory - po.trajectory).max()))
                actions += max(len(go.idx), len(po.idx))
                differ += sum(a != b for a, b in zip(go.idx, po.idx)) + abs(
                    len(go.idx) - len(po.idx))
    if not err <= NAVDP_GROUPED_TOL:
        raise AssertionError(f"serve batched navdp: grouped and per-cohort System-1 differ by "
                             f"{err} (tolerance {NAVDP_GROUPED_TOL})")
    sums = {k: round(sum(x), 4) for k, x in host_stats.items()}
    print(f"phase serve batched: path=serve_batched_navdp system1=navdp_async "
          f"cohorts={BATCH_COHORTS} rows={BATCH_ROWS} hw={BATCH_HW} history_frames=9 "
          f"max_new_tokens={BATCH_NEW_TOKENS} stop_id=-7 sample_trajs={BATCH_TRAJS} "
          f"s1_calls={BATCH_S1_CALLS} shared_decode=True shared_s1=True "
          f"warm_cycle_s={warm_s:.4f} grouped_cycle_s={cycle_s:.4f} "
          f"per_cohort_cycle_s={per_cohort_s:.4f} "
          f"grouped_call_host_s={[round(x[0], 4) for x in grouped_s]} "
          f"grouped_call_event_s={[round(x[1], 4) for x in grouped_s]} "
          f"grouped_call_streams={[x[2] for x in grouped_s]} "
          f"warm_last_grouped_call_profiled={profiled} "
          f"grouped_vs_per_cohort_traj_max_abs_err={err} tol={NAVDP_GROUPED_TOL} "
          f"actions={actions} actions_differing={differ} host_stats_sum_s={sums} "
          f"launches={launches} peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return {"serve_batched_navdp": launches}


def phase_evaluate_navdp(device, policy) -> dict:
    """The evaluator loop of `scripts/torch/bench_evaluator.py --system1
    navdp_async` (its functions: 4 cohorts x 12 streams, str hashing
    pinned, FakeEnv's depth at 224) on the NavDP policy: one warm run and
    one timed run of the same episodes of SHORT_MAX_STEP steps; every
    agent output well formed,
    every episode ended, K1 and K4-K8 launched, no backward kernel, no
    plain version. Prints actions/s, System-1's host seconds and the peak
    memory. Returns the timed run's launches."""
    import shutil

    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import BatchedN1Policy

    bench = bench_entry()
    if os.environ.get("PYTHONHASHSEED") != bench.HASH_SEED:
        raise AssertionError("evaluate navdp: str hashing is not pinned to the bench entry's seed")
    policy.tokenizer.eos_token_id = bench.STOP_ID
    traj_shape = (bench.NUM_SAMPLE_TRAJS, policy.cfg.predict_step_nums, 3)
    bad, calls, host_s, plain = [], collections.Counter(), collections.Counter(), \
        collections.Counter()
    spies = [_check_outputs(traj_shape, bad), *_plain_spies(plain)]
    spies += [(BatchedN1Policy, name, _spy(BatchedN1Policy, name, calls, name, host_s))
              for name in ("s2_prefill_submit", "s2_collect", "s1_submit", "s1_collect")]
    out_dir = WORK_DIR / "evaluate_navdp"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        warm = bench.evaluator_run(policy, str(out_dir / "warm"), max_step=SHORT_MAX_STEP)
        calls.clear()
        host_s.clear()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        run = bench.evaluator_run(policy, str(out_dir / "run0"), max_step=SHORT_MAX_STEP)
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        _restore(spies)
    if bad:
        raise AssertionError(f"evaluate navdp: {len(bad)} malformed agent outputs: {bad[:3]}")
    if plain:
        raise AssertionError(f"evaluate navdp: plain versions ran on the card: {dict(plain)}")
    missing = [k for k in EVAL_KERNELS if not launches[k]]
    if missing or launches["K2"] or launches["K3"]:
        raise AssertionError(f"evaluate navdp: kernels {missing} never launched, or a backward "
                             f"kernel did: {launches}")
    n = bench.BATCH * bench.COHORTS
    for r in (warm, run):
        ends = collections.Counter(e["fail_reason"] for e in r["records"])
        if len(r["records"]) != n or set(ends) - {"", "exceed_max_step"}:
            raise AssertionError(f"evaluate navdp: episodes did not all end: {dict(ends)}")
    if run["episode_steps"] != warm["episode_steps"]:
        raise AssertionError("evaluate navdp: the timed run took other episodes")
    print(f"phase evaluate: path=evaluate_navdp system1=navdp_async cohorts={bench.COHORTS} "
          f"rows={bench.BATCH} episodes={n} max_step={SHORT_MAX_STEP} "
          f"warm_actions_per_s={warm['actions_per_sec']:.4f} "
          f"actions_per_s={run['actions_per_sec']:.4f} wall_clock_s={run['wall_clock_s']:.4f} "
          f"actions_timed={run['actions_timed']} "
          f"action_latency_ms_p50={run['action_latency_p50_ms']} "
          f"action_latency_ms_p99={run['action_latency_p99_ms']} calls={dict(calls)} "
          f"host_s={ {k: round(v, 4) for k, v in host_s.items()} } "
          f"s1_host_s={host_s['s1_submit'] + host_s['s1_collect']:.4f} launches={launches} "
          f"plain_version_calls=0 peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return {"evaluate_navdp": launches}


# ----------------------------------------------------------------- train
def train_flops(cfg, batch) -> float:
    """Model flops of one step, bench.py's accounting: 8 per trainable
    matmul parameter per token for the remat decoder (2 forward, 4 backward,
    2 recompute) and the chunked lm_head, plus the attention scores from the
    packed row's segment lengths (8·d·ΣL² per layer); embedding, vision
    and System-1 excluded."""
    import numpy as np

    c = cfg.text
    d, f, v = c.hidden_size, c.intermediate_size, c.vocab_size
    kvd = c.num_key_value_heads * c.head_dim
    per_layer = 2 * d * d + 2 * d * kvd + 3 * d * f
    L = c.num_hidden_layers
    _, counts = np.unique(np.asarray(batch["segment_ids"])[0], return_counts=True)
    attn = 8.0 * d * float((counts.astype(np.float64) ** 2).sum()) * L
    return (8 * L * per_layer + 8 * d * v) * batch["input_ids"].shape[1] + attn


def build_trainer(device, ckpt=None, layers: int = TRAIN_LAYERS, want=None, mesh=None,
                  grad_accum: int = 1, use_ema: bool = False):
    """The full-width 7B `nextdit_async` policy (bf16) with remat, through
    the train launcher's policy route (`train_n1.build_policy`: from the
    checkpoint `ckpt`, else random N(0, 0.02) weights from seed 0) at
    TRAIN_LAYERS decoder layers, held equal by digest to `want` when given,
    then cut to its first `layers` decoder layers; and its trainer: chunked
    CE 1024, bf16 Adam moments, LLM trained, vision frozen; `mesh` (MeshCfg
    fields), grad_accum and use_ema as given."""
    import torch

    from internnav_tpu_torch.configs.trainer import ExpCfg, MeshCfg
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.trainer import train_n1
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    cfg = InternVLAN1Config.qwen25vl_7b("nextdit_async", remat=True,
                                        num_hidden_layers=TRAIN_LAYERS)
    policy = train_n1.build_policy(cfg, device, None if ckpt is None else str(ckpt))
    if want is not None:
        check_digests("train from the HF-layout checkpoint", state_digests(policy.model), want)
    if layers < TRAIN_LAYERS:  # the checkpoint's loader takes every layer it holds
        lm = policy.model.language_model
        lm.layers = torch.nn.ModuleList(list(lm.layers)[:layers])
        text = dataclasses.replace(cfg.text, num_hidden_layers=layers)
        policy.cfg = policy.model.cfg = dataclasses.replace(cfg, text=text)
        lm.cfg = text
        torch.cuda.empty_cache()
    exp = ExpCfg(name="chip_smoke_train", model_name="internvla_n1",
                 output_dir=str(WORK_DIR / "train_out"), mesh=MeshCfg(**(mesh or {})))
    exp.il.ce_chunk = 1024
    exp.il.remat = True
    exp.il.opt_state_dtype = "bf16"
    exp.il.grad_accum_steps = grad_accum
    exp.il.use_ema = use_ema
    return InternVLAN1Trainer(exp, policy, total_steps=4, tune_llm=True, tune_mm_vision=False)


def phase_train(device, store, ckpt: Path, want: dict) -> dict:
    """Optimizer steps of the full-width 7B policy, loaded from the
    HF-layout checkpoint `ckpt` and held equal to the parity build by
    digest (`want`), on one packed row; returns the kernel launches of the
    four steps."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    L = TRAIN_LAYERS
    t0 = time.perf_counter()
    trainer = build_trainer(device, ckpt)
    policy, cfg = trainer.policy, trainer.policy.cfg
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check_digests("train from the HF-layout checkpoint", state_digests(policy.model), want)
    batch = packed_row(store, TRAIN_LEN)
    t0 = time.perf_counter()
    prepared = trainer.prepare_batch(batch)
    torch.cuda.synchronize()
    vision_s = time.perf_counter() - t0

    model = policy.model
    lm = model.language_model
    # one parameter of each trainable group, copied to the host so that the
    # device's peak memory stays the trainer's own
    trainable = {
        "layers[0].q_proj": lm.layers[0].self_attn.q_proj.weight,
        f"layers[{L - 1}].down_proj": lm.layers[-1].mlp.down_proj.weight,
        "embed_tokens": lm.embed_tokens.weight,
        "lm_head": lm.lm_head.weight,
        "latent_queries": model.latent_queries,
        "traj_dit.layers[0].linear_2": model.traj_dit.layers[0].feed_forward.linear_2.weight,
        "action_decoder": model.action_decoder.weight,
    }
    trainable0 = {k: p.detach().cpu() for k, p in trainable.items()}
    frozen = model.visual.blocks[0].qkv.weight
    frozen0 = frozen.detach().clone()
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in model.parameters())

    # the peak of a second accumulated micro-batch, for phase train
    # sharded's reckoning: one untimed forward and backward into gradients
    # already held (zeros; no optimizer step follows), System-1 draws
    # handed in so that the generator's sequence stays the steps'
    n_rows = prepared["traj_poses"].shape[0]
    draws = (torch.zeros(n_rows, dtype=torch.int32, device=device),
             torch.zeros(n_rows, cfg.predict_step_nums, 3, device=device))
    torch.cuda.synchronize()
    static = torch.cuda.memory_allocated(device)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.zeros_like(p)
    torch.cuda.reset_peak_memory_stats(device)
    loss, _ = trainer.loss_fn(prepared, draws)
    loss.backward()
    torch.cuda.synchronize()
    accum_peak = torch.cuda.max_memory_allocated(device)
    del loss, _
    trainer.optimizer.zero_grad()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    times, metrics = [], []
    for step in range(4):
        before = (fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        t = time.perf_counter()
        m = trainer.train_step(prepared)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (fa.kernel_launches - before[0], fa.bwd_dkv_launches - before[1],
                  fa.bwd_dq_launches - before[2])
        if counts != (2 * L, L, L):
            raise AssertionError(f"train step {step + 1} launched (K1, K2, K3) = {counts}, "
                                 f"expected {(2 * L, L, L)}")
        metrics.append({k: float(v) for k, v in m.items()})
        if step == 1:
            same = [k for k, p in trainable.items() if torch.equal(p.detach().cpu(), trainable0[k])]
            if same:
                raise AssertionError(f"trainable parameters unchanged by step 2: {same}")
        if step:
            times.append(dt)
        else:
            first_s = dt
    totals = launch_counts()
    if any(totals[k] for k in ("K4", "K5", "K6a", "K6b", "K6b_fused", "K7")):
        raise AssertionError(f"the bf16 train step launched an int8 kernel: {totals}")
    if not totals["K8"]:
        raise AssertionError(f"the bf16 train steps' SwiGLU never launched K8: {totals}")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    for i, m in enumerate(metrics):
        bad = [k for k in ("lm_loss", "s1_loss", "loss", "grad_norm")
               if not torch.isfinite(torch.tensor(m[k]))]
        if bad:
            raise AssertionError(f"train step {i + 1}: {bad} not finite: {m}")
    if not torch.equal(frozen.detach(), frozen0):
        raise AssertionError("a frozen vision parameter changed")
    step_s = statistics.median(times)
    flops = train_flops(cfg, batch)
    last = metrics[-1]
    print(f"phase train: layers={L} (of 28) hidden={cfg.text.hidden_size} seq={TRAIN_LEN} "
          f"packed_samples={batch['num_packed']} traj_rows={int(batch['traj_mask'].sum())} "
          f"params={n_all} trainable={n_train} weights=hf_checkpoint load_s={build_s:.2f} "
          f"digests_equal={len(want)}/{len(want)} "
          f"vision_encode_s={vision_s:.4f} first_step_s={first_s:.4f} "
          f"step_s={[round(x, 4) for x in times]} step_s_median={step_s:.4f} "
          f"tokens_per_s={TRAIN_LEN / step_s:.1f} lm_loss={last['lm_loss']:.4f} "
          f"s1_loss={last['s1_loss']:.4f} grad_norm={last['grad_norm']:.4f} "
          f"losses={[round(m['loss'], 4) for m in metrics]} peak_mem_gib={peak_gib:.2f} "
          f"model_tflop_per_step={flops / 1e12:.2f} "
          f"mfu_vs_989_tflops_datasheet={flops / step_s / PEAK_BF16_FLOPS:.4f} "
          f"launches_per_step={(2 * L, L, L)} static_gib={static / 2**30:.2f} "
          f"accumulated_micro_batch_peak_gib={accum_peak / 2**30:.2f} gpu={gpu_line()!r}")
    return {"launches": totals, "n_train": n_train, "accum_peak_gib": accum_peak / 2**30}


#: the sharded phase keeps every layer while its reckoned peak (phase
#: train's peak of a micro-batch accumulated into held gradients, plus the
#: bf16 EMA) stays under this (GiB)
SHARDED_PEAK_LIMIT_GIB = 76.0
#: its first step's lm_loss against the two rows' forward-only token mean
#: with the same parameters: the same bf16 forward on the same weights, so
#: only the fp32 sums' order differs. The mean of the two rows' own means,
#: which weighs a row's tokens by 1 / its count, lies 2.9e-4 (relative)
#: from the token mean on these rows, so the limit sits well under that,
#: and that reading is held to miss it
SHARDED_LOSS_RTOL = 5e-5
#: the EMA after step 2 against d·e + (1 − d)·p on the host (fp32), over
#: |d·e| + |(1 − d)·p|: three bf16 roundings on the card (e·d, p·(1 − d),
#: their sum), each within bf16's unit roundoff 2^-8 of those terms
EMA_BF16_TOL = 3 * 2.0 ** -8


def packed_rows(store: str, max_len: int, n: int) -> dict:
    """n packed SFT rows of `max_len` tokens at the 7B vocab over
    consecutive samples of the store (packed_row's filling), stacked."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import (
        N1SampleDataset,
        n1_packed_collate_fn,
        stack_packed_rows,
        tokenize_sample,
    )
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import SimpleTokenizer

    cfg = InternVLAN1Config.qwen25vl_7b()
    tok = SimpleTokenizer(cfg.text.vocab_size)
    tpi = (TRAIN_HW // cfg.vision.patch_size // cfg.vision.spatial_merge_size) ** 2
    samples, total = [], 0
    for s in N1SampleDataset(store, predict_step_nums=cfg.predict_step_nums, num_history=2):
        samples.append(tokenize_sample(s, tok, tokens_per_image=tpi, n_query=cfg.n_query))
        total += len(samples[-1]["input_ids"])
        if total >= n * max_len + 2048:
            break
    rows, start = [], 0
    for _ in range(n):
        rows.append(n1_packed_collate_fn(samples[start:], max_len=max_len,
                                         predict_step_nums=cfg.predict_step_nums))
        start += rows[-1]["num_packed"]
    return stack_packed_rows(rows)


def phase_train_sharded(device, store, ckpt: Path, want: dict, train: dict) -> dict:
    """The sharded trainer on one card: a one-rank NCCL process group and
    mesh {"dp": 1, "tp": 1}, param_sharding "tp" with fsdp_rest (the
    decoder's projections, embedding and lm_head as tensor-parallel
    DTensors, the rest under FSDP2), grad_accum_steps 2 and the EMA, from
    the HF-layout checkpoint; two optimizer steps over two packed
    8192-token rows, one micro-batch a row. Holds the launches per
    micro-batch, the first step's lm_loss against the rows' forward-only
    token mean, the EMA after each step, the frozen tower and no plain
    version run; returns the two steps' launches."""
    import torch

    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.parallel.fsdp import is_dtensor, local
    from internnav_tpu_torch.trainer.ema import ema_decay

    # the depth: every layer unless the reckoned peak passes the limit: the
    # second micro-batch's peak with the first's gradients held (measured
    # by phase train) plus the EMA; a layer cut frees that layer's bf16
    # weights, gradients, two moments and EMA
    full = TRAIN_LAYERS
    ema_gib = train["n_train"] * 2 / 2**30
    reckoned = train["accum_peak_gib"] + ema_gib
    c = InternVLAN1Config.qwen25vl_7b().text
    kvd = c.num_key_value_heads * c.head_dim
    layer_gib = 10 * (2 * c.hidden_size ** 2 + 2 * c.hidden_size * kvd
                      + 3 * c.hidden_size * c.intermediate_size) / 2**30
    L = full if reckoned < SHARDED_PEAK_LIMIT_GIB else \
        full - math.ceil((reckoned - SHARDED_PEAK_LIMIT_GIB) / layer_gib)
    print(f"phase train sharded: reckoned peak {train['accum_peak_gib']:.2f} (phase train's "
          f"accumulated micro-batch) + {ema_gib:.2f} (the bf16 EMA of {train['n_train']} "
          f"trainable) = {reckoned:.2f} GiB against {SHARDED_PEAK_LIMIT_GIB}; "
          f"{layer_gib:.2f} GiB a layer -> layers={L} gpu={gpu_line()!r}")
    spies = []
    with one_rank_nccl(device):
        try:
            t0 = time.perf_counter()
            trainer = build_trainer(device, ckpt, layers=L, want=want, grad_accum=2, use_ema=True,
                                    mesh={"axes": {"dp": 1, "tp": 1}, "param_sharding": "tp",
                                          "fsdp_rest": True})
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            cfg, params = trainer.policy.cfg, trainer.params
            q = params["language_model.layers.0.self_attn.q_proj.weight"]
            vis = params["visual.blocks.0.qkv.weight"]
            if not (is_dtensor(q) and q.device_mesh.mesh_dim_names == ("tp",)
                    and is_dtensor(vis) and vis.device_mesh.mesh_dim_names == ("dp",)):
                raise AssertionError("phase train sharded: the layout is not tp + FSDP")
            batch = packed_rows(store, TRAIN_LEN, 2)
            prepared = trainer.prepare_batch(batch)
            pieces = trainer.micro_batches(prepared)
            if [p["input_ids"].shape[0] for p in pieces] != [1, 1]:
                raise AssertionError("phase train sharded: the micro-batches are not one row each")
            # each row's forward-only LM loss (sum, count) with the parameters before the step
            sums, counts = [], []
            with torch.no_grad():
                for piece in pieces:
                    n = piece["draw_rows"]
                    zeros = (torch.zeros(n, dtype=torch.int32, device=device),
                             torch.zeros(n, cfg.predict_step_nums, 3, device=device))
                    terms, _ = trainer._root(piece, zeros)
                    sums.append(float(terms["lm_loss"]))
                    counts.append(float(trainer.term_counts(piece)["lm_loss"]))
            ref_lm = sum(sums) / sum(counts)
            last = f"language_model.layers.{L - 1}.mlp.down_proj.weight"
            names = {"layers[0].q_proj": "language_model.layers.0.self_attn.q_proj.weight",
                     f"layers[{L - 1}].down_proj": last,
                     "embed_tokens": "language_model.embed_tokens.weight",
                     "lm_head": "language_model.lm_head.weight", "latent_queries": "latent_queries",
                     "traj_dit.layers[0].linear_2":
                         "traj_dit.layers.0.feed_forward.linear_2.weight",
                     "action_decoder": "action_decoder.weight"}

            def host(tensors):
                return {k: local(t).detach().cpu() for k, t in tensors.items()}

            p0 = host({k: params[n] for k, n in names.items()})
            frozen0 = local(vis).detach().clone()
            n_train = sum(local(p).numel() for p in params.values() if p.requires_grad)

            plain = collections.Counter()
            spies = _plain_spies(plain)
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            times, metrics, ema_err = [], [], 0.0
            e1 = None
            for step in (1, 2):
                before = (fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
                t = time.perf_counter()
                m = trainer.train_step(prepared)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                got = (fa.kernel_launches - before[0], fa.bwd_dkv_launches - before[1],
                       fa.bwd_dq_launches - before[2])
                if got != (2 * 2 * L, 2 * L, 2 * L):
                    raise AssertionError(f"train sharded step {step}: (K1, K2, K3) = {got}, "
                                         f"expected {(2 * L, L, L)} per micro-batch for 2 "
                                         "micro-batches")
                metrics.append({k: float(v) for k, v in m.items()})
                p_now = host({k: params[n] for k, n in names.items()})
                ema = {k: trainer.ema[n].cpu() for k, n in names.items()}
                if step == 1:
                    rel = abs(metrics[0]["lm_loss"] - ref_lm) / abs(ref_lm)
                    if rel > SHARDED_LOSS_RTOL:
                        raise AssertionError(f"train sharded: step 1 lm_loss "
                                             f"{metrics[0]['lm_loss']} against the rows' "
                                             f"forward-only {ref_lm} (rel {rel})")
                    row_means = sum(a / c for a, c in zip(sums, counts)) / len(sums)
                    rel_rows = abs(metrics[0]["lm_loss"] - row_means) / abs(row_means)
                    if not rel_rows > SHARDED_LOSS_RTOL:
                        raise AssertionError(f"train sharded: the mean of the rows' means "
                                             f"{row_means} is within {SHARDED_LOSS_RTOL} of "
                                             f"step 1's lm_loss (rel {rel_rows}): the hold "
                                             "cannot tell the token mean from it")
                    same = [k for k in names if not torch.equal(ema[k], p_now[k])]
                    if same:
                        raise AssertionError(f"train sharded: the EMA after step 1 (decay 0) "
                                             f"differs from the parameters: {same}")
                    e1 = ema
                else:
                    d = ema_decay(2)
                    for k in names:
                        a, b = d * e1[k].float(), (1 - d) * p_now[k].float()
                        err = ((ema[k].float() - (a + b)).abs() / (a.abs() + b.abs() + 1e-30)).max()
                        ema_err = max(ema_err, float(err))
                    if not ema_err <= EMA_BF16_TOL:
                        raise AssertionError(f"train sharded: the EMA after step 2 is {ema_err} "
                                             f"off d·e + (1 − d)·p (d = {d})")
                    # the warmup schedule's first update is zero (lr read at count 0)
                    same = [k for k in names if torch.equal(p_now[k], p0[k])]
                    if same:
                        raise AssertionError(f"train sharded: trainable parameters unchanged by "
                                             f"step 2: {same}")
            totals = launch_counts()
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        finally:
            _restore(spies)
    if plain:
        raise AssertionError(f"train sharded: plain versions ran on the card: {dict(plain)}")
    if any(totals[k] for k in ("K4", "K5", "K6a", "K6b", "K6b_fused", "K7")):
        raise AssertionError(f"train sharded: the bf16 steps launched an int8 kernel: {totals}")
    if not totals["K8"]:
        raise AssertionError(f"train sharded: the SwiGLU never launched K8: {totals}")
    if not torch.equal(local(vis).detach(), frozen0):
        raise AssertionError("train sharded: a frozen vision parameter changed")
    for i, m in enumerate(metrics):
        if not all(math.isfinite(m[k]) for k in ("lm_loss", "s1_loss", "loss", "grad_norm")):
            raise AssertionError(f"train sharded step {i + 1}: a metric is not finite: {m}")
    rows = [{"segment_ids": batch["segment_ids"][i:i + 1], "input_ids": batch["input_ids"][i:i + 1]}
            for i in range(2)]
    flops = sum(train_flops(cfg, r) for r in rows)
    step_s = times[-1]  # step 1 also pays the layout's first-call costs
    print(f"phase train sharded: mesh=dp1xtp1 param_sharding=tp+fsdp_rest grad_accum=2 ema=on "
          f"layers={L} (of 28) rows=2x{TRAIN_LEN} packed_samples={batch['num_packed']} "
          f"trainable={n_train} load_s={build_s:.2f} step_s={[round(x, 4) for x in times]} "
          f"step2_tokens_per_s={2 * TRAIN_LEN / step_s:.1f} "
          f"model_tflop_per_step={flops / 1e12:.2f} "
          f"step2_mfu_vs_989_tflops_datasheet={flops / step_s / PEAK_BF16_FLOPS:.4f} "
          f"peak_mem_gib={peak_gib:.2f} lm_loss_step1={metrics[0]['lm_loss']!r} "
          f"rows_forward_token_mean={ref_lm!r} rel_err={rel!r} rows_forward_means="
          f"{[a / c for a, c in zip(sums, counts)]} mean_of_row_means_rel_err={rel_rows!r} "
          f"loss_rtol={SHARDED_LOSS_RTOL} valid_labels={counts} "
          f"ema_step2_max_rel_err={ema_err:.3e} losses={[round(m['loss'], 4) for m in metrics]} "
          f"grad_norms={[round(m['grad_norm'], 4) for m in metrics]} "
          f"launches_per_micro_batch={(2 * L, L, L)} plain_version_calls=0 gpu={gpu_line()!r}")
    return {"launches": totals}


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        # FakeEnv seeds each episode's frames with hash(path_key): with str
        # hashing pinned, every run of the evaluate phase sees the same frames
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": HASH_SEED})
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None  # the port runs without jax: loading it now fails
    sys.modules["internnav_tpu"] = None  # nor the JAX package
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"settings: torch={torch.__version__} cuda={torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    laps, last = {}, [time.perf_counter()]

    def lap(name):  # the wall seconds of each group of phases
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now

    phase_build()
    lap("build")
    store = synthetic_store()
    kern = phase_kernels(device, store)
    lap("kernels_attention")
    int8 = phase_int8_kernels(device)
    lap("kernels_int8_k9_k10")
    from internnav_tpu_torch.realworld import serve

    by_path = {}
    t0 = time.perf_counter()
    parity = serve.build_policy("parity", device=device)
    torch.cuda.synchronize()
    prompts = []
    by_path.update(phase_serve(device, "parity", parity, time.perf_counter() - t0,
                               prompts=prompts))
    # the parity policy's bf16 weights as a checkpoint: the realtime and
    # evaluate paths and training start from it (HF layout) or from the
    # int8 policy loaded from it (native)
    root = checkpoint_root(2.25 * sum(t.numel() * t.element_size()
                                      for t in parity.model.state_dict().values()))
    try:
        hf = phase_checkpoint_write(parity, root)
        lap("serve_checkpoint_write")
        by_path.update(phase_serve_tp(device, parity, prompts))
        lap("serve_tp")
        del parity, prompts
        gc.collect()
        torch.cuda.empty_cache()
        realtime, load_s, realtime_digests = phase_checkpoint_load_realtime(device, hf)
        by_path.update(phase_serve(device, "realtime", realtime, load_s))
        by_path.update(phase_w8a16(device, realtime, "serve_realtime_w8a16"))
        w8a8_gap = check_decode_equals_reprefill(device, realtime)["with_k1_max_abs_err"]
        native = phase_checkpoint_save_native(realtime, root)
        del realtime
        gc.collect()
        torch.cuda.empty_cache()
        # int4: quantized on load from the same checkpoint, saved natively,
        # and served from the native directory (its recorded format wins)
        int4, _, int4_digests = phase_checkpoint_load_realtime(device, hf, "int4")
        native_int4 = phase_checkpoint_save_native(int4, root, "native_int4")
        del int4
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        int4 = serve.build_policy("realtime", device=device, ckpt=str(native_int4))
        torch.cuda.synchronize()
        int4_load_s = time.perf_counter() - t0
        check_digests("serve int4 from the native checkpoint", state_digests(int4.model),
                      int4_digests)
        by_path.update(phase_serve(device, "realtime", int4, int4_load_s,
                                   label="serve_realtime_int4", long_request=False))
        check_decode_equals_reprefill(device, int4, k1_gap_limit=K1_GAP_FACTOR * w8a8_gap)
        by_path.update(phase_w8a16(device, int4, "serve_realtime_w4a16"))
        del int4
        gc.collect()
        torch.cuda.empty_cache()
        lap("serve_checkpoint_w8a16_int4")
        by_path.update(phase_serve_batched(device))
        lap("serve_batched")
        gc.collect()
        torch.cuda.empty_cache()
        evaluate_launches, eval_rows = phase_evaluate(device, native, realtime_digests)
        by_path.update(evaluate_launches)
        kern["k1_serve"] += eval_rows.pop("K1", [])
        for kernel, rows in eval_rows.items():
            int8[kernel] += rows
        gc.collect()
        torch.cuda.empty_cache()
        lap("evaluate")
        by_path.update(phase_evaluate_int4(device, native_int4, int4_digests))
        lap("evaluate_int4")
        by_path.update(phase_evaluate_server(device, native))
        lap("evaluate_server")
        by_path.update(phase_evaluate_habitat(device, native))
        lap("evaluate_habitat")
        by_path.update(phase_evaluate_vln_pe(device, native))
        lap("evaluate_vln_pe")
        by_path.update(phase_evaluate_recurrent(device))
        lap("evaluate_recurrent")
        by_path.update(phase_train_recurrent(device))
        lap("train_recurrent")
        by_path.update(phase_evaluate_rdp(device))
        lap("evaluate_rdp")
        by_path.update(phase_train_rdp(device))
        lap("train_rdp")
        by_path.update(phase_evaluate_navdp_vn(device))
        lap("evaluate_navdp_vn")
        by_path.update(phase_train_navdp(device))
        lap("train_navdp")
        by_path.update(phase_dpt(device))
        lap("dpt")
        # the NavDP System-1 at 7B: one realtime policy serves, is held
        # against the host, serves batched and evaluates
        navdp, navdp_paths = phase_serve_navdp(device)
        by_path.update(navdp_paths)
        phase_navdp_card_vs_host(device, navdp)
        lap("serve_navdp")
        by_path.update(phase_serve_batched_navdp(device, navdp))
        lap("serve_batched_navdp")
        by_path.update(phase_evaluate_navdp(device, navdp))
        del navdp
        gc.collect()
        torch.cuda.empty_cache()
        lap("evaluate_navdp")
        train = phase_train(device, store, hf["dir"], hf["digests"])
        by_path["train"] = train["launches"]
        lap("train")
        gc.collect()
        torch.cuda.empty_cache()
        by_path["train_sharded"] = phase_train_sharded(device, store, hf["dir"], hf["digests"],
                                                       train)["launches"]
        lap("train_sharded")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    rows = {r["shape"]: r for r in kern["train"]}
    main_row = rows[f"train_T{TRAIN_LEN}"]  # the training step's attention shape
    dense_row = rows[f"dense_causal_T{TRAIN_LEN}"]
    shapes = kern["k1_serve"] + kern["train"]

    def paths(kernel):
        counts = {path: by_path[path][kernel] for path in by_path}
        return sum(counts.values()), counts

    def entry(name, kernel, source, replaces, err, kind, library_ms):
        launches, by = paths(kernel)
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "launches_by_path": by, "max_abs_err": err,
             "ms": main_row[f"{kind}_ms"],
             "plain_ms": main_row["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"],
             "bound_ms": main_row[f"{kind}_bound_ms"],
             "bound_by": main_row[f"{kind}_bound_by"], "library_ms": library_ms,
             "shape": main_row["shape"]}
        # the tiles each kernel walks per head (K1 in 128-query blocks), and
        # the dense causal row, where no tile can be skipped: the rate
        tiles = ("fwd_live_tiles", "fwd_causal_tiles") if kind == "fwd" else (
            "live_tiles", "causal_tiles")
        side = "fwd" if kind == "fwd" else "bwd"
        e.update(live_tiles=main_row[tiles[0]], causal_tiles=main_row[tiles[1]],
                 dense_causal={k: dense_row[k] for k in (
                     f"{kind}_ms", f"plain_{side}_ms", f"{kind}_bound_ms", f"sdpa_{side}_ms")})
        return e

    def int8_entry(name, kernel, route, source, replaces, shape):
        """An int8 kernel's line: its numbers at the decode shape `shape`
        (the path's most frequent launch), every checked row under
        "shapes"."""
        launches, by = paths(kernel)
        main = next(r for r in int8[kernel] if r["shape"] == shape)
        extra = {}
        if kernel == "K6a":
            extra["launches_by_prologue"] = {p: paths(f"K6a_{p}")[0]
                                             for p in ("rmsnorm", "swiglu", "plain")}
        if kernel in ("K6b", "K9", "K10"):  # launches that computed several projections
            extra["fused_launches"] = paths(f"{kernel}_fused")[0]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by, **extra,
                "max_abs_err": max(r["max_abs_err"] for r in int8[kernel]),
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape")},
                "shapes": int8[kernel]}

    errs = kern["errs"]
    k1_err = max([r["max_abs_err"] for r in kern["k1_serve"]] + errs["fwd"])
    tmax = PROMPT_T + MAX_NEW_TOKENS + N_QUERY
    kernels = [
        entry("flash_fwd", "K1", K1_SOURCE, K1_REPLACES, k1_err, "fwd", main_row["sdpa_fwd_ms"]),
        # the library call and the plain backward compute dq, dk and dv at once
        entry("flash_bwd_dkv", "K2", BWD_SOURCE, K2_REPLACES, max(errs["dkv"]), "dkv",
              main_row["sdpa_bwd_ms"]),
        entry("flash_bwd_dq", "K3", BWD_SOURCE, K3_REPLACES, max(errs["dq"]), "dq",
              main_row["sdpa_bwd_ms"]),
        # K4 and K5 are one kernel (decode_int8.cu), launched once per
        # layer by the decode step (n = 1) and by the latent chunk (n = 4)
        int8_entry("decode_int8", "K4", "cuda", DECODE_SOURCE, K4_REPLACES,
                   decode_shape(tmax, (tmax - N_QUERY - 1,), 1)),
        int8_entry("chunk_decode_int8", "K5", "cuda", DECODE_SOURCE, K5_REPLACES,
                   decode_shape(tmax, (tmax - N_QUERY,), N_QUERY)),
        int8_entry("quantize_rows", "K6a", "cuda", K6A_SOURCE, K6A_REPLACES,
                   "rmsnorm_residual_M1_K3584"),
        int8_entry("w8a8_gemm", "K6b", "cuda", GEMM_SOURCE, K6B_REPLACES,
                   "M1_N18944+18944_K3584"),
        int8_entry("rope_kv_write", "K7", "cuda", K7_SOURCE, K7_REPLACES,
                   kv_write_shape(True, (PROMPT_T + 17,), 1)),
        # the bf16 SiLU of every path: a parity decode token's SwiGLU is its
        # most frequent shape
        int8_entry("silu_bf16", "K8", "cuda", K6A_SOURCE, K8_REPLACES,
                   f"silu_mul_M1_K{K6A_I}"),
        # K9 and K10 at a decode token's gate projection of the int4 format
        int8_entry("w4a8_gemm", "K9", "cuda", K9_SOURCE, K9_REPLACES,
                   "M1_N18944_K3584_g128_int4"),
        int8_entry("w8a16_gemm", "K10", "cuda", K10_SOURCE, K10_REPLACES,
                   "M1_N18944_K3584_g128_int4"),
    ]
    kernels[0]["shapes"] = shapes
    print(f"phase timing: seconds={json.dumps(laps)} total={sum(laps.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
