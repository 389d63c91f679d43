#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (internnav_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers:
  1. build   — compile every CUDA kernel of the serving path from csrc/;
  2. kernels — hold each kernel against its plain PyTorch version at the
               shapes the serving path gives it, and time both;
  3. serve   — build the full-width Qwen2.5-VL-7B InternVLA-N1 policy (bf16,
               random weights from a seeded generator), serve it through the
               real-robot HTTP server and POST /reset + 4 /eval_dual requests;
               every kernel must have launched during the requests.
Then one JSON line of kernel results, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

K1_SOURCE = "internnav_tpu_torch/csrc/flash_fwd.cu"
K1_REPLACES = "internnav_tpu/ops/flash_attention.py:79"
K1_ATOL = K1_RTOL = 2e-2   # o: bf16 output rounding + bf16 P in the P.V product
LSE_ATOL = 1e-3            # lse: fp32 statistics from the same bf16 inputs
INSTRUCTION = "go past the table and stop at the second door on the left"


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

    t0 = time.perf_counter()
    _build.load_library("flash_fwd.cu")
    seconds = time.perf_counter() - t0
    log = _build.library_path("flash_fwd.cu").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {log.stem}: {line.strip()}")
    print(f"phase build: gpu={gpu_line()!r} seconds={seconds:.2f}")


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


def phase_kernels(device) -> list:
    import torch

    from internnav_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, q, k, v, seg, causal in k1_cases(device):
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
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal, segment_ids=seg))
        plain_ms = cuda_ms(lambda: fa.mha_reference(q, k, v, causal=causal, segment_ids=seg))
        rows.append({"shape": name, "q": list(q.shape), "kv_heads": k.shape[1],
                     "causal": causal, "max_abs_err": err, "lse_max_abs_err": lse_err,
                     "ms": ms, "plain_ms": plain_ms})
        print(f"phase kernels: K1 {name} q={tuple(q.shape)} kv_heads={k.shape[1]} "
              f"causal={causal} max_abs_err={err:.3e} lse_err={lse_err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} gpu={gpu_line()!r}")
    return rows


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
        fa.kernel_launches = 0  # count only the requests' launches
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
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    print(f"phase serve: layers={text.num_hidden_layers} hidden={text.hidden_size} "
          f"build_s={build_s:.2f} request_s={[round(x, 4) for x in latencies]} "
          f"generated_tokens={gen_tokens} calls={calls} flash_launches={launches} "
          f"peak_mem_gib={peak_gib:.2f} gpu={gpu_line()!r}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.modules["jax"] = None  # the port runs without jax: loading it now fails
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"settings: torch={torch.__version__} cuda={torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    phase_build()
    k1_rows = phase_kernels(device)
    launches = phase_serve(device)
    text_row = k1_rows[0]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": text_row["ms"], "plain_ms": text_row["plain_ms"], "shapes": k1_rows}]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
