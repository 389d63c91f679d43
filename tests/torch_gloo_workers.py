"""Workers that the CPU tests spawn in gloo process groups, and the
helpers that bound every spawning test in time. This module imports
neither JAX nor the test modules, so a spawned child loads only torch and
the port.

The ranks meet through a `FileStore` at a path of the test's own (no TCP
port: a free port read, released and reused can be taken by another
test's group in between, whose ranks the two groups would then share),
with a collective timeout of GROUP_TIMEOUT; the parent waits for them
under one deadline (`join_ranks`) and kills what is left, so a hang fails
its own test instead of using up the run."""

import contextlib
import datetime
import multiprocessing as mp
import os
import signal
import subprocess
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

#: a gloo collective's timeout in the workers: a lost rank fails its
#: peers' next collective instead of holding them for torch's 30 minutes
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def init_group(rank: int, world: int, store: str) -> None:
    """Join the gloo group of `world` ranks meeting at the file `store`."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)


def start_ranks(target, world: int, store: str, *args) -> list:
    """Start `world` processes running target(rank, world, store, *args),
    forked from a server that imported torch and this module once (world
    fresh interpreters would each import torch: seconds of CPU apiece on
    a host the other test workers share)."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    procs = [ctx.Process(target=target, args=(r, world, store, *args)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs: list, deadline_s: float) -> list:
    """Wait for the processes under one deadline shared by all the joins;
    kill those still running and fail. Returns their exit codes."""
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    assert not late, f"{len(late)} of {len(procs)} processes still ran after {deadline_s} s"
    return [p.exitcode for p in procs]


def run_ranks(target, world: int, store: str, *args, deadline_s: float = 120.0) -> None:
    """`start_ranks`, then `join_ranks`; every rank must exit 0."""
    codes = join_ranks(start_ranks(target, world, store, *args), deadline_s)
    assert codes == [0] * world, codes


@contextlib.contextmanager
def child_deadline(seconds: float):
    """Kill every multiprocessing child still running `seconds` after the
    block starts: a test that spawns through code it does not own
    (`graft_entry.dryrun_multichip`, whose joins then return) fails instead
    of hanging."""
    timer = threading.Timer(seconds, lambda: [p.kill() for p in mp.active_children()])
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def start_bounded(cmd, **kw) -> subprocess.Popen:
    """A subprocess in a process group of its own (text pipes), for
    `finish`."""
    return subprocess.Popen(cmd, process_group=0, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def finish(proc: subprocess.Popen, deadline: float) -> subprocess.CompletedProcess:
    """Wait for `proc` until the time.monotonic() `deadline`; past it, kill
    its whole process group (torchrun's ranks too) and raise
    TimeoutExpired."""
    try:
        out, err = proc.communicate(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_bounded(cmd, timeout: float, **kw) -> subprocess.CompletedProcess:
    """subprocess.run(cmd, capture_output=True, text=True, timeout=...) with
    the process group killed on timeout."""
    return finish(start_bounded(cmd, **kw), time.monotonic() + timeout)


def bounded_env(**extra) -> dict:
    """The environment of a test's subprocesses: two threads each, as the
    test workers run, so that a subprocess does not spin every core of a
    host the other workers share."""
    return {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2", **extra}


def collectives_worker(rank: int, world: int, store: str, out: str) -> None:
    """Every helper of `parallel.collectives` and `parallel.mesh.shard_batch`
    on a dp x tp = 2 x 2 mesh; this rank's results saved to out/rank{r}.pt."""
    from internnav_tpu_torch import parallel
    from internnav_tpu_torch.parallel.collectives import comm_device, mesh_group, pmax, psum_forward

    torch.set_num_threads(1)
    init_group(rank, world, store)
    try:
        mesh = parallel.make_mesh({"dp": -1, "tp": 2})
        saved = []
        parallel.save_on_master(saved.append, rank)
        x = torch.tensor([float(rank), 10.0 * rank])
        g = x.clone()
        parallel.grad_allreduce([g, None], mesh, "tp")
        leaf = x.clone().requires_grad_()
        summed = psum_forward(leaf, mesh_group(mesh, "tp"))
        (summed * torch.tensor([1.0, 2.0])).sum().backward()
        rows = {"a": torch.arange(8).reshape(4, 2), "odd": torch.arange(3), "n": 5}
        res = {
            "rank": parallel.get_rank(), "world": parallel.get_world_size(),
            "main": parallel.is_main_process(), "saved": saved,
            "device": str(comm_device()),
            "mean_scalar": parallel.all_reduce_mean(float(rank)),
            "mean_array": parallel.all_reduce_mean(np.array([rank, 2 * rank], np.float32)),
            "broadcast": parallel.host_broadcast({"from": rank}),
            "psum_mean_dp": parallel.psum_mean(x, mesh, "dp"),
            "psum_mean_tp": parallel.psum_mean(x, mesh, "tp"),
            "grad_allreduce_tp": g,
            "psum_forward_tp": summed.detach(), "psum_forward_grad": leaf.grad,
            "pmax_dp": pmax(x, mesh_group(mesh, "dp")),
            "shard_dp": parallel.shard_batch(rows, mesh, "dp"),
            "coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp")),
        }
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def serve_tp_worker(rank: int, world: int, store: str, spec_path: str, out: str) -> None:
    """The serving layout at tp = world over one gloo group: for each case
    of the pickled spec (a QwenTextConfig, a state-dict file, prompt ids
    and the decode's budget and stop ids) the text model is built whole,
    laid out with `apply_serve_tp` and greedy-decoded; and
    `vocab_argmax` on the spec's per-rank logits. Rank r's results are
    saved to out/rank{r}.pt."""
    import pickle

    from internnav_tpu_torch.model.basemodel.internvla_n1 import qwen_text as qt
    from internnav_tpu_torch.parallel.collectives import vocab_argmax
    from internnav_tpu_torch.parallel.tp import apply_serve_tp

    torch.set_num_threads(1)
    init_group(rank, world, store)
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        group = dist.new_group(list(range(world)))
        res = {}
        for name, case in spec["cases"].items():
            lm = qt.QwenTextModel(case["cfg"])
            lm.load_state_dict(torch.load(case["state"], weights_only=True))
            layout = apply_serve_tp(lm, group)
            ids = torch.as_tensor(case["ids"])
            B, T = ids.shape
            pos = torch.arange(T)[None, None].expand(3, B, T)
            with torch.inference_mode():
                tokens, lengths, _ = qt.greedy_generate(
                    lm, lm.embed(ids), pos, max_new_tokens=case["new"],
                    eos_token_ids=case["eos"])
            layer = lm.layers[0]
            res[name] = {
                "tokens": tokens, "lengths": lengths,
                "split": sorted(n for n, d in layout.items() if d),
                "reduce": (layer.self_attn.tp_group is not None,
                           layer.mlp.tp_group is not None),
                "starts": (lm.embed_start, lm.head_start),
                "heads": (lm.cfg.num_attention_heads, lm.cfg.num_key_value_heads),
                "buffers": {n: tuple(b.shape) for n, b in layer.named_buffers()},
            }
        local = torch.as_tensor(spec["argmax_logits"][rank])
        res["argmax"] = vocab_argmax(local, rank * local.shape[-1], group)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def serve_tp8_worker(rank: int, world: int, store: str, spec_path: str, out: str) -> None:
    """Tensor-parallel serving where ranks share the KV heads, over one
    gloo group of 8: `graft_entry._dryrun_serve` at each of the pickled
    spec's "decode" cases (a serving mesh and a text model: tokens,
    lengths and teacher-forced logits, gathered), then the spec's N1
    policy loaded from its HF-layout checkpoint at dp=1 x tp=8, this rank
    reading only its blocks (`from_pretrained_torch(tp_group=)`), and
    `fused_s2` on the recorded prompt; and the same policy loaded so from
    its native directory (`from_pretrained(tp_group=)`), its state held
    equal. Rank r's results are saved to out/rank{r}.pt."""
    import pickle

    from internnav_tpu_torch.graft_entry import _dryrun_serve
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.parallel import collectives
    from internnav_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    init_group(rank, world, store)
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        res = {name: _dryrun_serve({"serve": case}) for name, case in spec["decode"].items()}
        mesh = make_mesh({"dp": 1, "tp": world})
        policy = InternVLAN1Policy.from_pretrained_torch(
            spec["ckpt"], spec["cfg"], device="cpu", tp_group=mesh.get_group("tp"))
        lm = policy.model.language_model
        tokens, lengths, latents = policy.fused_s2(*spec["prompt"], spec["new"])
        native = InternVLAN1Policy.from_pretrained(
            spec["native"], spec["cfg"], device="cpu", tp_group=mesh.get_group("tp")
        ).model.state_dict()
        res["policy"] = {
            "tokens": tokens, "lengths": lengths, "latents": latents,
            "heads": (lm.cfg.num_attention_heads, lm.cfg.num_key_value_heads),
            "blocks": dict(lm.serve_blocks), "staged": dict(collectives.staged),
            "native_equal": all(torch.equal(t, native[n])
                                for n, t in policy.model.state_dict().items()),
        }
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def time_major_dp_worker(rank: int, world: int, store: str, spec_path: str, out: str) -> None:
    """A recurrent trainer at dp = world over one gloo group, with the
    pickled spec's grad_accum_steps: its `micro_batches` of the spec's
    time-major probe batch (nested dicts, leaves whose envs the split does
    not divide), then two steps on the spec's batch with the gradients
    each optimizer step takes. Rank r's results are saved to
    out/rank{r}.pt."""
    import pickle

    from internnav_tpu_torch.configs.trainer import ExpCfg, IlCfg, MeshCfg
    from internnav_tpu_torch.model import get_policy
    from internnav_tpu_torch.trainer.cma_trainer import CMATrainer, Seq2SeqTrainer

    torch.set_num_threads(1)
    init_group(rank, world, store)
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        name = spec["name"]
        pol = get_policy(name).build(spec["cfg"], device="cpu", depth_hw=spec["depth_hw"])
        pol.net.load_state_dict(torch.load(spec["state"], weights_only=True))
        exp = ExpCfg(name="t", model_name=name, output_dir=f"{out}/rank{rank}", model=spec["cfg"],
                     il=IlCfg(**spec["il"]), mesh=MeshCfg(axes={"dp": world}))
        cls = CMATrainer if name == "cma" else Seq2SeqTrainer
        trainer = cls(exp, pol, total_steps=3)
        pieces = trainer.micro_batches(spec["probe"])
        seen, step = [], trainer.optimizer.step

        def snap():
            seen.append({n: p.grad.detach().clone() for n, p in trainer.optimizer.params})
            return step()

        trainer.optimizer.step = snap
        metrics = [{k: float(v) for k, v in trainer.train_step(spec["batch"]).items()}
                   for _ in range(2)]
        params = {n: p.detach().clone() for n, p in pol.net.named_parameters()}
        torch.save({"pieces": pieces, "metrics": metrics, "grads": seen, "params": params,
                    "dp": (trainer.dp, trainer.accum)}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
