"""The port's tools against the JAX package's: scripts/torch/
bench_flash_attention.py's pair count, profile_s2.py's categories, the
three micro-benchmarks' refusal without CUDA, inference_demo.py against
the JAX policy's System-2 texts, make_fake_dataset.py against its
original, the five configs of the warm-started finetunes and the Kujiale
VLN-PE evaluation against theirs, and eval.py under torchrun (two gloo
ranks) against one process.
"""

import gzip
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from internnav_tpu import configs as jconfigs
from internnav_tpu.model.basemodel.internvla_n1.model import InternVLAN1Config as JConfig
from internnav_tpu.model.basemodel.internvla_n1.model import InternVLAN1Model as JModel
from internnav_tpu.model.basemodel.internvla_n1.policy import InternVLAN1Policy as JPolicy
from internnav_tpu_torch import configs as tconfigs
from internnav_tpu_torch.model.basemodel.internvla_n1 import policy as tpolicy
from internnav_tpu_torch.model.weights.from_jax import load_from_jax
from test_torch_system1 import n1_params

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
#: the port's configs and their originals
CONFIGS = {
    "cma_plus_cfg.py": ("train/configs/cma_plus_cfg.py", "exp_cfg"),
    "seq2seq_plus_cfg.py": ("train/configs/seq2seq_plus_cfg.py", "exp_cfg"),
    "challenge_train_kujiale_cfg.py": ("train/configs/challenge_train_kujiale_cfg.py", "exp_cfg"),
    "challenge_train_mp3d_cfg.py": ("train/configs/challenge_train_mp3d_cfg.py", "exp_cfg"),
    "h1_cma_cfg_kujiale.py": ("eval/configs/h1_cma_cfg_kujiale.py", "eval_cfg"),
}
#: the launcher test's deadline for both evaluations, run at once
LAUNCH_DEADLINE_S = 150


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return _load(REPO / "scripts" / "torch" / f"{name}.py", f"port_{name}")


# ------------------------------------------------------------ micro-benchmarks
@pytest.mark.parametrize("T", [1, 7, 64, 97])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bench_live_pairs_equal_a_brute_force_count(T, causal):
    """bench_flash_attention's live (q, k) pairs of cu = [0, T/3, T/2, T]
    against the masks counted element by element."""
    fb = _port("bench_flash_attention")
    cu = fb.segment_bounds(T)
    seg = np.searchsorted(np.asarray(cu[1:-1]), np.arange(T), side="right")
    keep = seg[:, None] == seg[None, :]
    if causal:
        keep &= np.tril(np.ones((T, T), bool))
    assert fb.live_pairs(cu, causal) == int(keep.sum())
    assert fb.formula_pairs(T) == T * T / 2


def test_flash_bench_counts_the_default_rows_live_pairs():
    """At T = 8192 the JAX formula counts ~2.6x the live pairs."""
    fb = _port("bench_flash_attention")
    live = fb.live_pairs(fb.segment_bounds(8192))
    assert live == 13_052_132
    assert 2.5 < fb.formula_pairs(8192) / live < 2.6


#: XLA op names of JAX's trace lines, and what JAX's `_category` calls them
JAX_NAMES = ["fusion.12", "copy.3", "convert_element_type.4", "transpose.1", "bitcast.2",
             "copy_fusion.5", "dot.5", "dot_general.7", "convolution.1",
             "dynamic-update-slice.7", "dynamic-update-slice-fusion", "scatter.1", "gather.2",
             "all-reduce.1", "collective-permute.3", "custom-call.3 flash_attention",
             "decode_attention.1", "while.1", "add.1", "broadcast_in_dim.2", "reduce.4"]
#: device kernel names of the port's trace, and their categories
PORT_NAMES = {
    "void (anonymous namespace)::flash_fwd_kernel<128>(CUtensorMap, CUtensorMap)":
        "attention-kernel",
    "void (anonymous namespace)::flash_bwd_dkv_kernel(CUtensorMap)": "attention-kernel",
    "void (anonymous namespace)::decode_int8_kernel((anonymous namespace)::Args)":
        "attention-kernel",
    "void (anonymous namespace)::rope_kv_write_kernel((anonymous namespace)::Args)":
        "cache-write",
    "void (anonymous namespace)::quantize_rows_kernel<__nv_bfloat16, 1>(__nv_bfloat16 const*)":
        "fusion",
    "void (anonymous namespace)::silu_bf16_kernel<true>(__nv_bfloat16 const*)": "fusion",
    "void qgemm::decode_split_kernel<8, 2>(qgemm::DecodeParams)": "matmul/conv",
    "void qgemm::prefill_kernel<4>(CUtensorMap, CUtensorMap)": "matmul/conv",
    "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNT": "matmul/conv",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "matmul/conv",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn>":
        "matmul/conv",
    "Memcpy HtoD (Pinned -> Device)": "copy/convert/transpose",
    "void at::native::elementwise_kernel<128, 2, at::native::direct_copy_kernel_cuda>":
        "copy/convert/transpose",
    "void at::native::index_elementwise_kernel<128, 4>": "scatter/gather",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>": "reduction",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>": "softmax",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>": "reduction",
}


def test_profile_s2_categories_agree_with_jax_and_map_the_port_kernels():
    jp = _load(REPO / "scripts" / "tools" / "profile_s2.py", "jax_profile_s2")
    ps = _port("profile_s2")
    for name in JAX_NAMES:
        assert ps._category(name) == jp._category(name), name
    for name, cat in PORT_NAMES.items():
        assert ps._category(name) == cat, name


def test_profile_s2_parses_a_saved_trace(tmp_path, capsys):
    """`--parse-only` on a chrome trace: device events summed by category
    and by name, host events left out."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "dur": d} for n, d in (
        ("void qgemm::decode_split_kernel<8, 2>(qgemm::DecodeParams)", 30.0),
        ("void qgemm::decode_split_kernel<8, 2>(qgemm::DecodeParams)", 20.0),
        ("void (anonymous namespace)::flash_fwd_kernel<128>(CUtensorMap)", 40.0))]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                "dur": 10.0}, {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 500.0}]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    got = _port("profile_s2").main(["--parse-only", "--logdir", str(tmp_path)])
    assert got["total_ms"] == pytest.approx(0.1)
    assert got["categories"] == pytest.approx({"matmul/conv": 0.05, "attention-kernel": 0.04,
                                               "copy/convert/transpose": 0.01})
    assert got["top"][0][0] == pytest.approx(0.05)
    assert "device time by category" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["bench_flash_attention", "bench_w4", "profile_s2"])
def test_micro_benchmarks_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).run()


# -------------------------------------------------------------------- demo
def test_demo_prints_a_line_per_frame_on_the_cpu(tmp_path, capsys):
    """Two PNG frames of a folder through PIL and the port's resize: one
    System-2 line each, then its goal and actions."""
    from PIL import Image

    rs = np.random.RandomState(1)
    for i, hw in enumerate((40, 90)):
        Image.fromarray(rs.randint(0, 255, (hw, hw, 3), np.uint8)).save(tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not a frame")
    demo = _port("inference_demo")
    assert [f.shape for f in demo.load_frames(str(tmp_path), 56)] == [(56, 56, 3)] * 2
    lines = demo.main(["--device", "cpu", "--frames", str(tmp_path)])
    assert [ln for ln in lines if "llm:" in ln] == [ln for ln in lines if ln[:3] in ("[0]",
                                                                                       "[1]")]
    assert len([ln for ln in lines if "llm:" in ln]) == 2
    assert capsys.readouterr().out.strip().splitlines() == lines


def test_demo_texts_equal_jax_on_jax_weights(tmp_path):
    """A JAX policy of the JAX demo's tiny bf16 config (numpy draws in
    the shapes of its init, `test_torch_system1.n1_params`, held in bf16 as
    bench.py holds its weights: the port keeps an RMSNorm scale in fp32
    where JAX rounds it to the model dtype) carried to a native directory
    of the port: the demo's
    System-2 texts on two of its synthetic frames (a folder of 56-pixel
    PNGs: two prompt lengths for JAX to compile, not six) equal the JAX
    policy's `s2_step` texts, step by step."""
    from PIL import Image

    demo = _port("inference_demo")
    for i, frame in enumerate(demo.load_frames(None, 56)[:2]):
        Image.fromarray(frame).save(tmp_path / f"{i}.png")
    jcfg = JConfig.tiny("nextdit_async")
    jmodel = JModel(jcfg)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    n1_params(jmodel, jcfg, seed=2))
    jpol = JPolicy(jmodel, params, jcfg)
    cfg = demo.demo_config("tiny", 2)
    model = load_from_jax(tpolicy.build_model(cfg, device="cpu"), params)
    tpolicy.InternVLAN1Policy(model).save_pretrained(str(tmp_path / "ckpt"))
    lines = demo.main(["--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
                       "--frames", str(tmp_path)])
    want = []
    for t, frame in enumerate(demo.load_frames(str(tmp_path), 56)):
        jpol.s2_step(frame, "go forward and stop at the door", max_new_tokens=demo.NEW_TOKENS)
        want.append(f"[{t}] llm: {jpol.llm_output!r}")
    assert [ln for ln in lines if "llm:" in ln] == want


# ------------------------------------------------------------ data, configs
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("split", ["val_unseen", "val_seen"])
def test_make_fake_dataset_equals_jax(tmp_path, seed, split):
    jm = _load(REPO / "scripts" / "tools" / "make_fake_dataset.py", "jax_make_fake_dataset")
    pm = _port("make_fake_dataset")
    got = pm.make_split(str(tmp_path / "port"), split, 5, seed)
    want = jm.make_split(str(tmp_path / "jax"), split, 5, seed)
    assert got.endswith(f"{split}/{split}.json.gz")
    with gzip.open(got, "rt") as f, gzip.open(want, "rt") as g:
        ours, ref = json.load(f), json.load(g)
    assert ours == ref and len(ours["episodes"]) == 5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tool_configs_equal_jax_configs(name):
    """Field by field (their model_dump), and the fields each sets."""
    ref_path, attr = CONFIGS[name]
    port = tconfigs.load_py_config(str(REPO / "scripts" / "torch" / "configs" / name), attr)
    ref = jconfigs.load_py_config(str(REPO / "scripts" / ref_path), attr)
    assert type(port).__module__.startswith("internnav_tpu_torch.configs")
    assert type(port).__name__ == type(ref).__name__
    assert port.model_dump() == ref.model_dump()
    if attr == "exp_cfg":
        assert port.il.model_fields_set == ref.il.model_fields_set
        assert port.il.load_from_ckpt and port.il.ckpt_to_load


# ----------------------------------------------------------------- launcher
def _records(out: Path) -> list:
    """Every rank's per-episode records of an evaluation's resume store."""
    recs = []
    for path in sorted((out / "resume").glob("sample_data_*.jsonl")):
        recs += [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    return sorted(recs, key=lambda r: r["key"])


def test_eval_under_torchrun_shards_and_gathers_like_one_process(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 scripts/torch/
    eval.py --config <fake_cma_cfg.py> --device cpu` (gloo) beside one
    process without torchrun, both at once under one deadline: each rank
    evaluated its shard, the ranks' per-episode records are the one
    process's, both ranks print the one process's metrics (but the
    timings), and result.json gets one line."""
    from torch_gloo_workers import bounded_env, finish, start_bounded

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "import os\n"
        "from internnav_tpu_torch.configs import load_py_config\n"
        f"eval_cfg = load_py_config({str(REPO / 'scripts/torch/configs/fake_cma_cfg.py')!r})\n"
        f"eval_cfg.dataset.base_data_dir = {str(REPO / 'data' / 'fake_r2r')!r}\n"
        "eval_cfg.output_dir = os.environ['EVAL_OUT']\n")
    eval_py = str(REPO / "scripts" / "torch" / "eval.py")
    args = [eval_py, "--config", str(cfg), "--device", "cpu"]
    runs = {
        "one": [sys.executable, *args],
        "two": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "--log-dir", str(tmp_path / "logs"), "--redirects", "1",
                *args],
    }
    procs = {k: start_bounded(cmd, cwd=REPO, env=bounded_env(
        PYTHONHASHSEED="0", EVAL_OUT=str(tmp_path / k))) for k, cmd in runs.items()}
    deadline = time.monotonic() + LAUNCH_DEADLINE_S
    done = {k: finish(p, deadline) for k, p in procs.items()}
    for k, d in done.items():
        assert d.returncode == 0, (k, d.stderr[-3000:])
    timings = ("wall_clock_s", "actions_timed") + tuple(
        f"action_latency_{s}_ms" for s in ("p50", "p90", "p99", "mean"))

    def result(metrics):
        return {k: v for k, v in metrics.items() if k not in timings}

    one = json.loads(done["one"].stdout.strip().splitlines()[-1])
    # each rank's stdout, in its own file under the log directory
    outs = sorted((tmp_path / "logs").rglob("stdout.log"), key=lambda p: p.parent.name)
    printed = [json.loads(p.read_text().strip().splitlines()[-1]) for p in outs]
    assert len(printed) == 2 and all(result(m) == result(one) for m in printed)
    assert one["num_episodes"] == 4
    assert [json.loads(ln) for ln in (tmp_path / "two" / "result.json").read_text()
            .splitlines()] in ([printed[0]], [printed[1]])
    shards = sorted((tmp_path / "two" / "resume").glob("sample_data_*.jsonl"))
    assert [p.name for p in shards] == ["sample_data_0.jsonl", "sample_data_1.jsonl"]
    assert all(len(p.read_text().splitlines()) == 2 for p in shards)
    assert _records(tmp_path / "two") == _records(tmp_path / "one")
