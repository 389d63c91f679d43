#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (internnav_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers:
  1. build   — compile every CUDA kernel from csrc/ (one nvcc per source,
               all started together) and print ptxas registers / spills;
  2. kernels — hold each kernel against its plain PyTorch version and time
               both: K1 at the serving shapes; K1, K2 and K3 at the training
               head shape (28 heads, 4 KV heads, D=128, causal, segment ids of
               a real packed row) at T=2048 and a ragged T; at T=8192 only
               times (kernel, plain version, and scaled_dot_product_attention
               as a yardstick) and the bound;
  3. serve   — build the full-width Qwen2.5-VL-7B InternVLA-N1 policy (bf16,
               random weights from a seeded generator), serve it through the
               real-robot HTTP server and POST /reset + 4 /eval_dual requests;
               K1 must have launched during the requests;
  4. train   — with the serving policy freed: the full-width 7B
               `nextdit_async` policy at TRAIN_LAYERS decoder layers with
               remat, one packed 8192-token row from a synthetic store through
               `InternVLAN1Trainer.prepare_batch`, one untimed and 3 timed
               optimizer steps (chunked CE 1024, bf16 Adam moments, vision
               frozen); each timed step must launch K1 2·L times and K2, K3
               L times each.
Then one JSON line of kernel results, the GPU's name and power limit, and as
the last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; with no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
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
K1_ATOL = K1_RTOL = 2e-2   # o: bf16 output rounding + bf16 P in the P.V product
LSE_ATOL = 1e-3            # lse: fp32 statistics from the same bf16 inputs
# dq/dk/dv: bf16 outputs, and P / dS rounded to bf16 as tensor-core operands
# and summed over up to T terms: atol 1% of the largest plain-version entry
# (at least 1e-2) plus rtol 2%
BWD_ATOL_FRAC = 1e-2
BWD_RTOL = 2e-2
INSTRUCTION = "go past the table and stop at the second door on the left"
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TRAIN_LEN = 8192
TRAIN_LAYERS = 28
TRAIN_HW = 224
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build() -> None:
    from internnav_tpu_torch.ops import _build

    sources = ("flash_fwd.cu", "flash_bwd.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load_library, sources))
    seconds = time.perf_counter() - t0
    for src in sources:
        log = _build.library_path(src).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    win = vision_indices((14, 2, 112), ((1, 30, 30),))["window_segments"]
    seg = torch.as_tensor(np.asarray(win)[None], dtype=torch.int32, device=device)
    cases.append(("vision_S900", rnd(1, 16, 900, 80), rnd(1, 16, 900, 80),
                  rnd(1, 16, 900, 80), seg, False))
    return cases


def check_k1(name, q, k, v, seg, causal):
    """K1 against the plain version; returns (o, lse, max_abs_err, lse_err)."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg)
    ref_o, ref_lse = fa.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                                      segment_ids=seg, return_lse=True)
    torch.cuda.synchronize()
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


def sdpa_ms(q, k, v, seg, do, causal: bool):
    """scaled_dot_product_attention on the same inputs and masks (K/V
    repeated per query head, boolean mask): (forward ms, backward ms). A
    yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    G = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    T = q.shape[2]
    mask = seg[:, :, None] == seg[:, None, :]
    if causal:
        mask = mask & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()[None]
    mask = mask[:, None]
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask), reps=10)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    bwd = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), reps=10)
    return fwd, bwd


def phase_kernels(device, store) -> dict:
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    k1_rows = []
    for name, q, k, v, seg, causal in k1_cases(device):
        _, _, err, lse_err = check_k1(name, q, k, v, seg, causal)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg))
        plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, causal=causal, segment_ids=seg))
        k1_rows.append({"shape": name, "q": list(q.shape), "kv_heads": k.shape[1],
                        "causal": causal, "max_abs_err": err, "lse_max_abs_err": lse_err,
                        "ms": ms, "plain_ms": plain_ms})
        print(f"phase kernels: K1 {name} q={tuple(q.shape)} kv_heads={k.shape[1]} "
              f"causal={causal} max_abs_err={err:.3e} lse_err={lse_err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} gpu={gpu_line()!r}")

    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)

    errs = {"fwd": [], "dkv": [], "dq": []}
    train_rows = []
    for T in (2048, 1000, TRAIN_LEN):  # training heads; 1000 is ragged (not a multiple of 64)
        seg = torch.as_tensor(packed_row(store, T)["segment_ids"], device=device)
        q, k, v, do = rnd(1, 28, T, 128), rnd(1, 4, T, 128), rnd(1, 4, T, 128), rnd(1, 28, T, 128)
        name = f"train_T{T}"
        row = {"shape": name, "q": list(q.shape), "kv_heads": 4, "causal": True,
               "segments": int(seg.unique().numel())}
        if T != TRAIN_LEN:  # the plain versions' fp32 scores at 8192 take 7.5 GB a call
            o, lse, err, _ = check_k1(name, q, k, v, seg, True)
            e_dkv, e_dq = check_bwd(name, q, k, v, seg, True, o, lse, do)
            errs["fwd"].append(err)
            errs["dkv"].append(e_dkv)
            errs["dq"].append(e_dq)
            row.update(fwd_err=err, dkv_err=e_dkv, dq_err=e_dq)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, segment_ids=seg)
        di = (o.float() * do.float()).sum(-1)
        pairs = valid_pairs(seg.cpu(), True)
        row.update(
            fwd_ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True, segment_ids=seg)),
            dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal=True,
                                                         segment_ids=seg)),
            dq_ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, di, causal=True,
                                                       segment_ids=seg)),
            plain_fwd_ms=cuda_ms(lambda: fa.mha_reference(q, k, v, causal=True,
                                                          segment_ids=seg), reps=5),
            plain_bwd_ms=cuda_ms(lambda: fa.flash_backward_reference(
                q, k, v, seg, seg, o, lse, do, True), reps=5),
            pairs_per_head=pairs)
        for kind in ("fwd", "dkv", "dq"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(kind, q, k, pairs)
        if T == TRAIN_LEN:
            row["sdpa_fwd_ms"], row["sdpa_bwd_ms"] = sdpa_ms(q, k, v, seg, do, True)
        train_rows.append(row)
        print("phase kernels: " + " ".join(
            f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items()) + f" gpu={gpu_line()!r}")
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return {"k1_serve": k1_rows, "train": train_rows, "errs": errs}


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


def build_agent(device):
    """The full-width 7B `parity` policy (random weights, seed 0) and its
    agent, synchronous and re-planning System-2 after every action."""
    from internnav_tpu_torch.agent.internvla_n1_agent import InternVLAN1Agent
    from internnav_tpu_torch.realworld import serve

    policy = serve.build_policy("parity", device=device)
    return policy, InternVLAN1Agent(policy, async_s2=False, sys2_max_forward_step=1)


def phase_serve(device) -> int:
    """Serve the 7B policy through the real-robot HTTP server; returns the
    kernel launches counted during the requests."""
    import numpy as np
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa
    from internnav_tpu_torch.realworld import serve

    t0 = time.perf_counter()
    policy, agent = build_agent(device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = policy.cfg.text
    calls = {"s2_step": 0, "s1_step_latent": 0}

    def counted(name):
        fn = getattr(policy, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    for name in calls:
        setattr(policy, name, counted(name))
    port = _free_port()
    server = serve.RealWorldServer(agent, "127.0.0.1", port)
    thread = server.run(background=True)
    rng = np.random.default_rng(0)
    latencies, gen_tokens = [], []
    try:
        if _post(port, "/reset", {}) != (200, {"status": "ok"}):
            raise AssertionError("/reset failed")
        torch.cuda.reset_peak_memory_stats(device)
        # count only the requests' launches
        fa.kernel_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        for _ in range(4):
            rgb, depth = request_frames(rng)
            body = {"instruction": INSTRUCTION, "rgb": serve.encode_npy(rgb),
                    "depth": serve.encode_npy(depth)}
            t = time.perf_counter()
            code, resp = _post(port, "/eval_dual", body)
            latencies.append(time.perf_counter() - t)
            traj = np.asarray(resp.get("trajectory", []), np.float64)
            if code != 200 or traj.shape != (policy.cfg.predict_step_nums, 3) \
                    or not np.isfinite(traj).all():
                raise AssertionError(f"/eval_dual gave {code} with trajectory shape {traj.shape}")
            gen_tokens.append(len(policy.last_gen_tokens))
        launches = fa.kernel_launches
        bwd_launches = fa.bwd_dkv_launches + fa.bwd_dq_launches
    finally:
        server.shutdown()
        thread.join(timeout=30)
        agent.close()
    if calls["s2_step"] != 4 or calls["s1_step_latent"] < 1:
        raise AssertionError(f"main path calls {calls}: want 4 System-2 and >= 1 System-1")
    # one launch per prefill layer, one per windowed ViT block of each new frame
    windowed = policy.cfg.vision.depth - len(policy.cfg.vision.fullatt_block_indexes)
    expected = 4 * text.num_hidden_layers + 4 * windowed
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expected}")
    if bwd_launches:
        raise AssertionError("serving launched a backward kernel")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    print(f"phase serve: layers={text.num_hidden_layers} hidden={text.hidden_size} "
          f"build_s={build_s:.2f} request_s={[round(x, 4) for x in latencies]} "
          f"generated_tokens={gen_tokens} calls={calls} flash_launches={launches} "
          f"peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return launches


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


def build_trainer(device):
    """The full-width 7B `nextdit_async` policy (bf16, random N(0, 0.02)
    weights, seed 0) at TRAIN_LAYERS decoder layers with remat, and its trainer:
    chunked CE 1024, bf16 Adam moments, LLM trained, vision frozen."""
    from internnav_tpu_torch.configs.trainer import ExpCfg
    from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    cfg = InternVLAN1Config.qwen25vl_7b("nextdit_async", remat=True,
                                        num_hidden_layers=TRAIN_LAYERS)
    policy = InternVLAN1Policy.build(cfg, device=device)
    exp = ExpCfg(name="chip_smoke_train", model_name="internvla_n1",
                 output_dir=str(WORK_DIR / "train_out"))
    exp.il.ce_chunk = 1024
    exp.il.remat = True
    exp.il.opt_state_dtype = "bf16"
    return InternVLAN1Trainer(exp, policy, total_steps=4, tune_llm=True, tune_mm_vision=False)


def phase_train(device, store) -> dict:
    """Optimizer steps of the full-width 7B policy on one packed row;
    returns the kernel launches of the four steps."""
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    L = TRAIN_LAYERS
    t0 = time.perf_counter()
    trainer = build_trainer(device)
    policy, cfg = trainer.policy, trainer.policy.cfg
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
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
    fa.kernel_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
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
    totals = [fa.kernel_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches]
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
          f"params={n_all} trainable={n_train} build_s={build_s:.2f} "
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
    serve_launches = phase_serve(device)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(device, store)
    k1_train, k2_train, k3_train = train["launches"]
    main_row = kern["train"][-1]  # T=8192, the training step's attention shape
    shapes = kern["k1_serve"] + kern["train"]

    def entry(name, source, replaces, launches, by_path, err, kind, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path, "max_abs_err": err,
                "ms": main_row[f"{kind}_ms"],
                "plain_ms": main_row["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"],
                "bound_ms": main_row[f"{kind}_bound_ms"],
                "bound_by": main_row[f"{kind}_bound_by"], "library_ms": library_ms,
                "shape": main_row["shape"]}

    errs = kern["errs"]
    k1_err = max([r["max_abs_err"] for r in kern["k1_serve"]] + errs["fwd"])
    kernels = [
        entry("flash_fwd", K1_SOURCE, K1_REPLACES, serve_launches + k1_train,
              {"serve": serve_launches, "train": k1_train}, k1_err, "fwd",
              main_row["sdpa_fwd_ms"]),
        # the library call and the plain backward compute dq, dk and dv at once
        entry("flash_bwd_dkv", BWD_SOURCE, K2_REPLACES, k2_train, {"train": k2_train},
              max(errs["dkv"]), "dkv", main_row["sdpa_bwd_ms"]),
        entry("flash_bwd_dq", BWD_SOURCE, K3_REPLACES, k3_train, {"train": k3_train},
              max(errs["dq"]), "dq", main_row["sdpa_bwd_ms"]),
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
