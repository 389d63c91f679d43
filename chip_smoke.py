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
               multiple of 8 and on inputs no 16-byte boundary aligns;
  3. serve   — build the full-width Qwen2.5-VL-7B InternVLA-N1 policy in the
               `parity` profile (bf16, random weights from a seeded
               generator), serve it through the real-robot HTTP server and
               POST /reset + 4 /eval_dual requests; K1 must have launched
               during the requests, and no int8 kernel; K8 as computed
               from the frames, layer passes and System-1 calls;
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
               captures and warm-up steps are checked;
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
               and 3 timed runs: actions/s per run and their median,
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
               with path=evaluate). Python's str hash is pinned
               (PYTHONHASHSEED=0; the script re-executes itself with it),
               so FakeEnv draws the same frames in every run;
  7. train   — with the serving policies freed: the full-width 7B
               `nextdit_async` policy at TRAIN_LAYERS decoder layers with
               remat, loaded from the HF-layout checkpoint through the
               train launcher's `--ckpt` route (`train_n1.build_policy`)
               and held equal by digest to the parity build, one packed
               8192-token row from a synthetic store through
               `InternVLAN1Trainer.prepare_batch`, one untimed and 3 timed
               optimizer steps (chunked CE 1024, bf16 Adam moments, vision
               frozen); each timed step must launch K1 2·L times and K2, K3
               L times each.
Every kernel's launch count is set to 0 just before each of the six
paths (serve, serve realtime, the long realtime request, serve batched's
timed stream, the evaluate phase's timed runs, train) and read just
after. Then one JSON
line of kernel results, the GPU's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; with no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
               "quantize_rows.cu", "rope_kv_write.cu")
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
    """The realtime profile's kernels at the 7B shapes, and K8 at the bf16
    paths' SiLU shapes; rows by kernel."""
    import torch

    g = torch.Generator(device=device).manual_seed(2)
    rows = (int8_k6a_rows(device, g) + int8_gemm_rows(device, g)
            + int8_decode_rows(device, g) + int8_kv_write_rows(device, g)
            + [k8_row(device, g, *shape) for shape in K8_ROWS])
    return {name: [r for r in rows if r["kernel"] == name]
            for name in ("K4", "K5", "K6a", "K6b", "K7", "K8")}


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
    return policy, InternVLAN1Agent(policy, async_s2=False, sys2_max_forward_step=1)


LAUNCH_KEYS = ("K1", "K2", "K3", "K4", "K5", "K6a", "K6a_rmsnorm", "K6a_swiglu", "K6a_plain",
               "K6b", "K6b_fused", "K7")


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
            "K6b_fused": quant.w8a8_fused_launches, "K7": quant.kv_write_launches}


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
    layer, K5 per chunk layer."""
    L = cfg.text.num_hidden_layers
    windowed = cfg.vision.depth - len(cfg.vision.fullatt_block_indexes)
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want["K1"] = len(steps) * (L + windowed)
    decode_passes = sum(1 + s for s in steps)  # decode steps + chunk, per layer
    passes = len(steps) + decode_passes  # and the prefill
    velocity = 2 * dit_layers + 2
    want["K8"] = (len(steps) * cfg.vision.depth + s1_calls * S1_STEPS * velocity
                  + (L * passes if profile == "parity" else 0))
    if profile == "realtime":
        want.update(K4=L * sum(steps), K5=L * len(steps), K6a=4 * L * passes + logits_calls,
                    K6a_rmsnorm=2 * L * passes, K6a_swiglu=L * passes,
                    K6a_plain=L * passes + logits_calls,
                    K6b=4 * L * decode_passes + 7 * L * len(steps) + logits_calls,
                    K6b_fused=2 * L * decode_passes, K7=L * passes)
    return want


#: the System-1 denoise's Euler steps (`generate_traj_nextdit`'s default)
S1_STEPS = 10


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
                                   calls["s1_step_latent"], len(policy.model.traj_dit.layers))
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")
    return steps


def phase_serve(device, profile: str, policy, build_s: float) -> dict:
    """Serve `policy`, the 7B policy of `profile` (built or loaded in
    build_s), through the real-robot HTTP server; returns every kernel's
    launches by path: the 4 requests, and with the realtime profile also
    the long request, each held equal to `expected_serve_launches`."""
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
    port = _free_port()
    server = serve.RealWorldServer(agent, "127.0.0.1", port)
    thread = server.run(background=True)
    rng = np.random.default_rng(0)
    latencies, gen_tokens, loop = [], [], []
    by_path = {}
    long = {}
    try:
        if _post(port, "/reset", {}) != (200, {"status": "ok"}):
            raise AssertionError("/reset failed")
        torch.cuda.reset_peak_memory_stats(device)
        lm_calls["decode_chunk_grouped"] = 0
        reset_launch_counts()  # count only the requests' launches
        for _ in range(4):
            before = decode_stats()
            latencies.append(_eval_dual(port, policy, *request_frames(rng)))
            gen_tokens.append(len(policy.last_gen_tokens))
            loop.append(decode_stats() - before)
        by_path[f"serve_{profile}"] = launch_counts()
        steps = _check_requests(policy, profile, f"serve {profile}", calls,
                                lm_calls["decode_chunk_grouped"], gen_tokens, loop,
                                by_path[f"serve_{profile}"])
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        if profile == "realtime":
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
    L = text.num_hidden_layers
    # per decode step with its lm_head call
    per_step = {"K4": L, "K6a": 4 * L + 1, "K6a_rmsnorm": 2 * L, "K6a_swiglu": L,
                "K6a_plain": L + 1, "K6b": 4 * L + 1, "K6b_fused": 2 * L,
                "K7": L} if profile == "realtime" else {}
    print(f"phase serve: profile={profile} weight_dtype={text.weight_dtype} "
          f"kv_dtype={text.kv_dtype} layers={text.num_hidden_layers} hidden={text.hidden_size} "
          f"build_s={build_s:.2f} resident_gib={build_mem_gib:.2f} "
          f"request_s={[round(x, 4) for x in latencies]} generated_tokens={gen_tokens} "
          f"decode_steps={steps} decode_loop={[dict(st) for st in loop]} "
          f"launches={by_path[f'serve_{profile}']} "
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
    first with room for the bf16 checkpoint and the int8 one (at most as
    large) with 10% to spare, and on a RAM-backed file system also in free
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


def phase_checkpoint_load_realtime(device, hf: dict):
    """The realtime policy from the HF-layout checkpoint, quantized on load
    (`serve.build_policy("realtime", ckpt=...)`), held bitwise equal by
    digest to `InternVLAN1Policy.build` of the realtime profile from seed
    0, which is built first (its digests and peak device memory taken, then
    freed). The load's peak device memory must not exceed the build's.
    Returns (the loaded policy, its load seconds, the realtime digests)."""
    import torch

    from internnav_tpu_torch.realworld import serve

    torch.cuda.reset_peak_memory_stats(device)
    base_gib = torch.cuda.memory_allocated(device) / 2**30
    t0 = time.perf_counter()
    built = serve.build_policy("realtime", device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    want = state_digests(built.model)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loaded = serve.build_policy("realtime", device=device, ckpt=str(hf["dir"]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    resident_gib = torch.cuda.memory_allocated(device) / 2**30
    check_digests("serve realtime from the HF-layout checkpoint", state_digests(loaded.model),
                  want)
    if load_peak_gib > build_peak_gib:
        raise AssertionError(f"the int8 load peaked at {load_peak_gib:.2f} GiB, above the random "
                             f"realtime build's {build_peak_gib:.2f} GiB")
    print(f"phase checkpoint: load layout=hf profile=realtime quantized_on_load=True "
          f"read_gb={hf['bytes'] / 1e9:.3f} load_s={load_s:.2f} "
          f"load_gb_per_s={hf['bytes'] / 1e9 / load_s:.3f} load_peak_mem_gib={load_peak_gib:.2f} "
          f"random_build_s={build_s:.2f} random_build_peak_mem_gib={build_peak_gib:.2f} "
          f"resident_gib={resident_gib:.2f} before_gib={base_gib:.2f} "
          f"digests_equal={len(want)}/{len(want)} gpu={gpu_line()!r}")
    return loaded, load_s, want


def phase_checkpoint_save_native(policy, root: Path) -> Path:
    """`save_pretrained` of the loaded int8 policy into root/native."""
    native = root / "native"
    t0 = time.perf_counter()
    policy.save_pretrained(str(native))
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(native)
    print(f"phase checkpoint: save layout=native weight_dtype={policy.cfg.text.weight_dtype} "
          f"dir={native} gb={nbytes / 1e9:.3f} save_s={save_s:.2f} "
          f"save_gb_per_s={nbytes / 1e9 / save_s:.3f} gpu={gpu_line()!r}")
    return native


# --------------------------------------------------------- serve batched
# the checked cycles' instructions: one per stream, all of INSTRUCTION's
# length (a word is a token), so every prompt stays BATCH_PROMPT tokens long
OBJECTS = ("table", "sofa", "stairs", "plant")
ORDINALS = ("first", "second", "third", "fourth")
SIDES = ("left", "right", "end")


def own_instruction(ci: int, r: int) -> str:
    return (f"go past the {OBJECTS[ci % 4]} and stop at the {ORDINALS[r % 4]} door on the "
            f"{SIDES[(r // 4) % 3]}")


def expected_batched_launches(cfg, cycles: int, cohorts: int, rows: int,
                              vision_k1: int, dit_layers: int) -> dict:
    """Launches of `cycles` shared-decode cycles of `cohorts` cohorts of
    `rows` rows, each decoding the full BATCH_NEW_TOKENS budget: a cycle is
    each cohort's vision call (vision_k1 K1 launches, K8 once a ViT block)
    and its BATCH_S1_CALLS System-1 denoises (S1_STEPS velocities over
    NextDiT's `dit_layers`, K8 as in `expected_serve_launches`) and prefill (K1 a
    layer; per layer pass K6a 4 and K7 1, K6b 7 on the prefill tiles; one
    lm_head call at its rows: K6a PLAIN 1, K6b 1), then one grouped decode
    (BATCH_NEW_TOKENS steps over `cohorts` cache groups: K4 and K7 once a
    group and layer; K6a 4 a layer; K6b 7 a layer at more than
    GEMM_DECODE_MAX_M rows (the prefill tiles), else 4 with 2 fused; K6a
    PLAIN and K6b one more a step with the lm_head, every step but the
    last) and one grouped latent chunk (K5 and K7 once a group and layer,
    K6a and K6b as a step at its rows x n_query rows)."""
    from internnav_tpu_torch.ops.quant import GEMM_DECODE_MAX_M

    L, G = cfg.text.num_hidden_layers, cohorts
    prefills = cycles * cohorts
    steps, logit_steps = cycles * BATCH_NEW_TOKENS, cycles * (BATCH_NEW_TOKENS - 1)
    passes = prefills + steps + cycles

    def k6b(M):  # K6b launches and fused launches a layer pass of M rows
        return (7, 0) if M > GEMM_DECODE_MAX_M else (4, 2)

    (dec, dec_fused), (chk, chk_fused) = k6b(G * rows), k6b(G * rows * cfg.n_query)
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want.update(K1=prefills * (L + vision_k1), K4=L * G * steps, K5=L * G * cycles,
                K6a=4 * L * passes + prefills + logit_steps, K6a_rmsnorm=2 * L * passes,
                K6a_swiglu=L * passes, K6a_plain=L * passes + prefills + logit_steps,
                K6b=7 * L * prefills + L * (dec * steps + chk * cycles) + prefills + logit_steps,
                K6b_fused=L * (dec_fused * steps + chk_fused * cycles),
                K7=L * prefills + L * G * (steps + cycles),
                K8=prefills * (cfg.vision.depth
                               + BATCH_S1_CALLS * S1_STEPS * (2 * dit_layers + 2)))
    return want


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
    window_block, full_block = policy._vision_host_indices(BATCH_HW, BATCH_HW, BATCH_ROWS)[1]
    v = cfg.vision
    vision_k1 = (0 if window_block else v.depth - len(v.fullatt_block_indexes)) + \
        (0 if full_block else len(v.fullatt_block_indexes))
    want = expected_batched_launches(cfg, cycles, BATCH_COHORTS, BATCH_ROWS, vision_k1,
                                     len(policy.model.traj_dit.layers))
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
          f"loops={len(buffers._loops)} vision_k1_per_call={vision_k1} launches={launches} "
          f"peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return {"serve_batched": launches}


# -------------------------------------------------------------- evaluate
EVAL_RUNS = 3  # timed evaluator runs after the warm one
#: the plain versions of the kernels, by ops module: none may run on the card
PLAIN_VERSIONS = {
    "flash_attention": ("mha_reference", "flash_backward_reference", "gqa_decode_reference",
                        "gqa_chunk_decode_reference"),
    "quant": ("quantize_rows", "rmsnorm_quantize_reference", "swiglu_quantize_reference",
              "w8a8_linear_reference", "write_kv_cache_reference", "rope_kv_write_reference"),
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

    import numpy as np
    import torch

    from internnav_tpu_torch.evaluator import vln_pipelined_evaluator as pipe
    from internnav_tpu_torch.model.basemodel.internvla_n1.serving import (
        BatchedN1Policy,
        SharedDecodePool,
    )
    from internnav_tpu_torch.ops import activations as act
    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.ops import quant

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
    apply = pipe._Cohort.apply

    def checked_apply(self, agent_out):
        for o in agent_out:
            traj = o.get("trajectory")
            if len(o["action"]) != 1 or o["action"][0] not in (0, 1, 2, 3) or (
                    traj is not None and (traj.shape != traj_shape
                                          or not np.isfinite(traj).all())):
                bad.append((o["action"], None if traj is None else traj.shape))
        return apply(self, agent_out)

    modules = {"flash_attention": fa, "quant": quant, "activations": act}
    restore = [(modules[m], name, _spy(modules[m], name, plain, f"{m}.{name}"))
               for m, names in PLAIN_VERSIONS.items() for name in names]
    pipe._Cohort.apply = checked_apply
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
        for obj, name, fn in reversed(restore):
            setattr(obj, name, fn)
        pipe._Cohort.apply = apply
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


def build_trainer(device, ckpt=None):
    """The full-width 7B `nextdit_async` policy (bf16) at TRAIN_LAYERS
    decoder layers with remat, through the train launcher's policy route
    (`train_n1.build_policy`: from the checkpoint `ckpt`, else random
    N(0, 0.02) weights from seed 0), and its trainer: chunked CE 1024, bf16
    Adam moments, LLM trained, vision frozen."""
    from internnav_tpu_torch.configs.trainer import ExpCfg
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.trainer import train_n1
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    cfg = InternVLAN1Config.qwen25vl_7b("nextdit_async", remat=True,
                                        num_hidden_layers=TRAIN_LAYERS)
    policy = train_n1.build_policy(cfg, device, None if ckpt is None else str(ckpt))
    exp = ExpCfg(name="chip_smoke_train", model_name="internvla_n1",
                 output_dir=str(WORK_DIR / "train_out"))
    exp.il.ce_chunk = 1024
    exp.il.remat = True
    exp.il.opt_state_dtype = "bf16"
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
          f"launches_per_step={(2 * L, L, L)} gpu={gpu_line()!r}")
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
    phase_build()
    store = synthetic_store()
    kern = phase_kernels(device, store)
    int8 = phase_int8_kernels(device)
    from internnav_tpu_torch.realworld import serve

    by_path = {}
    t0 = time.perf_counter()
    parity = serve.build_policy("parity", device=device)
    torch.cuda.synchronize()
    by_path.update(phase_serve(device, "parity", parity, time.perf_counter() - t0))
    # the parity policy's bf16 weights as a checkpoint: the realtime and
    # evaluate paths and training start from it (HF layout) or from the
    # int8 policy loaded from it (native)
    root = checkpoint_root(2 * sum(t.numel() * t.element_size()
                                   for t in parity.model.state_dict().values()))
    try:
        hf = phase_checkpoint_write(parity, root)
        del parity
        gc.collect()
        torch.cuda.empty_cache()
        realtime, load_s, realtime_digests = phase_checkpoint_load_realtime(device, hf)
        by_path.update(phase_serve(device, "realtime", realtime, load_s))
        native = phase_checkpoint_save_native(realtime, root)
        del realtime
        gc.collect()
        torch.cuda.empty_cache()
        by_path.update(phase_serve_batched(device))
        gc.collect()
        torch.cuda.empty_cache()
        evaluate_launches, eval_rows = phase_evaluate(device, native, realtime_digests)
        by_path.update(evaluate_launches)
        kern["k1_serve"] += eval_rows.pop("K1", [])
        for kernel, rows in eval_rows.items():
            int8[kernel] += rows
        gc.collect()
        torch.cuda.empty_cache()
        by_path["train"] = phase_train(device, store, hf["dir"], hf["digests"])["launches"]
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
        if kernel == "K6b":  # launches that computed several projections at once
            extra["fused_launches"] = paths("K6b_fused")[0]
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
    ]
    kernels[0]["shapes"] = shapes
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
