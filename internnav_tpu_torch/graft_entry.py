"""Entry point of the port: the port's counterpart of `__graft_entry__.entry()`.

    fn, args = entry(); logits, traj = fn(*args)

One dual-system forward step of InternVLA-N1 on the GPU at a small config:
System-2 prefill of a prompt with four image tokens and the trajectory
queries → traj latents → System-1 NextDiT flow-matching denoise → the
sampled trajectories. The small config keeps the 7B's structure (4 text
layers, a 4-block vision tower with one full-attention block, GQA, the
NextDiT System-1) at widths whose attention head dims are the ones the
prefill kernel takes (128 for text, 80 for vision). Weights are random
from seed 0, drawn on the host and moved to the device, so every device
runs the same weights; `params=` loads a JAX-layout parameter tree instead
(`model/weights/from_jax`). `entry(device="cpu")` runs the plain versions
on the host (the tests); without a device it asks for the GPU and raises
without one. `dryrun_multichip(n)` trains one step of the tiny policy
sharded over n gloo CPU processes, then greedy-decodes with its decoder
laid out for serving over a dp x tp mesh of the same processes (its spec
may skip the training step, and name the serving mesh and text model).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from internnav_tpu_torch.model.basemodel.internvla_n1.model import InternVLAN1Config
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import QwenTextConfig
from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_vision import QwenVisionConfig


def small_n1_config(dtype: torch.dtype = torch.bfloat16) -> InternVLAN1Config:
    """`__graft_entry__._small_n1_config`'s structure (bf16 by default), at
    widths with 128-wide text heads and 80-wide vision heads."""
    text = QwenTextConfig(vocab_size=2048, hidden_size=512, intermediate_size=1024,
                          num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=128, mrope_section=(16, 24, 24), dtype=dtype)
    vision = QwenVisionConfig(depth=4, hidden_size=160, intermediate_size=320, num_heads=2,
                              window_size=56, fullatt_block_indexes=(3,), out_hidden_size=512,
                              dtype=dtype)
    base = text.vocab_size - 6  # compact special ids (SimpleTokenizer layout)
    return InternVLAN1Config(text=text, vision=vision, system1="nextdit", n_query=4,
                             predict_step_nums=16, image_token_index=base + 4,
                             traj_token_index=base + 5)


def entry(device=None, *, dtype: torch.dtype = torch.bfloat16,
          params: Optional[Mapping[str, Any]] = None) -> Tuple[Callable, tuple]:
    """(fn, args): fn(*args) → (logits (1, 64, vocab), trajectories (4,
    16, 3)) of one forward step of the small policy in `dtype` on
    `device`, with the seed-0 weights or `params`."""
    from internnav_tpu_torch import require_cuda
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.model.weights.from_jax import load_from_jax

    dev = require_cuda() if device is None else torch.device(device)
    cfg = small_n1_config(dtype)
    model = InternVLAN1Policy.build(cfg, device="cpu").model
    if params is not None:
        load_from_jax(model, params)
    model = model.to(dev)
    B, T = 1, 64
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 1024, (B, T))
    ids[0, 4:8] = cfg.image_token_index  # 4 image tokens (one 56x56 frame)
    ids[0, -cfg.n_query:] = cfg.traj_token_index
    img_embeds = torch.from_numpy(rs.randn(4, cfg.text.hidden_size)).to(dev, dtype)
    pos = torch.arange(T, device=dev)[None, None].expand(3, B, T)
    x_init = torch.from_numpy(rs.randn(4, cfg.predict_step_nums, 3)).float().to(dev)

    @torch.inference_mode()
    def forward(input_ids, img_embeds, pos, x_init):
        embeds = model.embed_multimodal(input_ids, img_embeds)
        logits, hidden, _ = model.prefill(embeds, pos)
        latents = hidden[:, -cfg.n_query:, :]
        traj = model.generate_traj_nextdit(latents, x_init=x_init, num_inference_steps=4,
                                           num_sample_trajs=4)
        return logits, traj

    return forward, (torch.from_numpy(ids).to(dev), img_embeds, pos, x_init)


# ------------------------------------------------------------ multichip
def dryrun_multichip(n_devices: int = 8, *, spec: Optional[Mapping[str, Any]] = None,
                     timeout: float = 600.0) -> dict:
    """`__graft_entry__.dryrun_multichip` on `n_devices` gloo CPU processes.
    Phase 1: one N1 training step of the tiny policy on a dp × tp mesh
    (tp=2 where n_devices is even, else pure dp), param_sharding "tp" with
    fsdp_rest, one packed batch of the synthetic SFT store, and the
    production trainer. Phase 2, serving: the same processes lay the tiny
    policy's decoder out for serving on a dp × tp mesh of that shape
    (`parallel/tp.apply_serve_tp`) and greedy-decode B = 2·dp rows of T =
    24 random ids (`RandomState(0)`, as JAX's phase), 4 new tokens, EOS
    (3,), each dp group its own rows, then re-prefill each row's prompt and
    tokens (teacher forcing). Prints both and returns rank 0's metrics,
    with "serve": the tokens (B, 4), lengths (B,) and teacher-forced
    logits (B, 4, vocab) at the generated positions of every row, gathered
    on rank 0.

    `spec` overrides the run (the CPU tests): "mesh" (MeshCfg fields),
    "il" (IlCfg fields), "state" (a state-dict file for the tiny fp32
    model, which both phases start from), "batch" (a pickled raw packed
    batch), "draws" (train_step's System-1 draws), "output_dir" and
    "resume" (restore the newest checkpoint there first), "save" (write a
    checkpoint after the step), "gather" (return the gathered parameters
    and optimizer state), "train" (False: skip phase 1) and "serve"
    (phase 2's "mesh" axes, and its text model: a "text" QwenTextConfig
    with its "state" file). The workers are this module's: a child imports
    neither the caller's module nor JAX."""
    import multiprocessing as mp
    import tempfile

    tp = 2 if n_devices % 2 == 0 else 1
    spec = dict(spec or {})
    spec.setdefault("mesh", {"axes": {"dp": n_devices // tp, "tp": tp},
                             "param_sharding": "tp", "fsdp_rest": True})
    with tempfile.TemporaryDirectory() as tmp:
        spec.setdefault("output_dir", f"{tmp}/out")
        out = f"{tmp}/rank0.pt"
        # forked from a server that imported torch and this module once (a
        # fresh interpreter a rank would import torch n times over), not
        # from this process, whose threads a fork would not carry over
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        procs = [ctx.Process(target=_dryrun_worker, args=(r, n_devices, spec, out, tmp))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dryrun_multichip: worker exit codes {codes}")
        result = torch.load(out, weights_only=False)
    m = spec["mesh"]
    if "metrics" in result:
        print("dryrun_multichip ok:", {k: round(v, 4) for k, v in result["metrics"].items()},
              f"(mesh {m['axes']}, param_sharding={m.get('param_sharding', 'replicated')}"
              f"{'+fsdp_rest' if m.get('fsdp_rest') else ''}, gloo x {n_devices})")
    axes = result["serve"]["mesh"]
    print("dryrun_multichip serving ok:", tuple(result["serve"]["tokens"].shape),
          f"(greedy decode dp={axes['dp']} x tp={axes['tp']})")
    return result


def _dryrun_worker(rank: int, world: int, spec: Mapping[str, Any], out: str, tmp: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    # the ranks meet at a file of the run's own directory: a free TCP port,
    # read and released, can be taken by another group before rank 0 binds it
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        result = _dryrun_step(spec, tmp) if spec.get("train", True) else {}
        result["serve"] = _dryrun_serve(spec)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _dryrun_step(spec: Mapping[str, Any], tmp: str) -> dict:
    import pickle

    from internnav_tpu_torch.configs.trainer import ExpCfg, MeshCfg
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import InternVLAN1Policy
    from internnav_tpu_torch.trainer.internvla_n1_trainer import InternVLAN1Trainer

    cfg = InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
    policy = InternVLAN1Policy(_dryrun_model(spec, cfg))
    if "batch" in spec:
        with open(spec["batch"], "rb") as f:
            batch = pickle.load(f)
    else:
        batch = _synthetic_batch(policy, cfg, tmp)
    exp = ExpCfg(name="graft_dryrun", model_name="internvla_n1", output_dir=spec["output_dir"],
                 mesh=MeshCfg(**spec["mesh"]))
    for k, v in spec.get("il", {}).items():
        setattr(exp.il, k, v)
    trainer = InternVLAN1Trainer(exp, policy, total_steps=1)
    if spec.get("resume"):
        trainer.maybe_restore()
    draws = spec.get("draws")
    metrics = trainer.train_on_batches([batch], None if draws is None else [draws])
    result = {"metrics": metrics, "step": trainer.step}
    if spec.get("save"):
        trainer.save_checkpoint()
    if spec.get("gather"):
        result["state"] = trainer.full_state()
    return result


def _dryrun_model(spec: Mapping[str, Any], cfg: InternVLAN1Config):
    """The tiny fp32 model on the host: spec["state"]'s weights, else the
    seed-0 build (the same on every process)."""
    from internnav_tpu_torch.model.basemodel.internvla_n1.policy import (
        InternVLAN1Policy,
        build_model,
    )

    if "state" not in spec:
        return InternVLAN1Policy.build(cfg, device="cpu").model
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(spec["state"], weights_only=True))
    return model


def _dryrun_serve(spec: Mapping[str, Any]) -> dict:
    """Phase 2 on this process: a decoder laid out for serving over a dp ×
    tp mesh of every process (spec["serve"]["mesh"]; by default tp=2 where
    their number is even), this dp group's rows decoded and then
    re-prefilled with their tokens; every row's tokens, lengths and
    teacher-forced logits gathered, in row order, with the mesh's axes.
    The decoder is spec["serve"]'s text model where given, else the tiny
    N1 policy's."""
    import torch.distributed as dist

    from internnav_tpu_torch.model.basemodel.internvla_n1.qwen_text import (
        QwenTextModel,
        greedy_generate,
    )
    from internnav_tpu_torch.parallel.mesh import make_mesh, rank_of, row_bounds
    from internnav_tpu_torch.parallel.tp import apply_serve_tp

    serve = spec.get("serve", {})
    if "text" in serve:
        lm = QwenTextModel(serve["text"])
        lm.load_state_dict(torch.load(serve["state"], weights_only=True))
    else:
        lm = _dryrun_model(spec, InternVLAN1Config.tiny("nextdit", dtype=torch.float32)
                           ).language_model
    vocab = lm.cfg.vocab_size
    world = dist.get_world_size()
    tp = 2 if world % 2 == 0 else 1
    axes = dict(serve.get("mesh", {"dp": world // tp, "tp": tp}))
    mesh = make_mesh(axes)
    apply_serve_tp(lm, mesh.get_group("tp"))
    dp, dp_rank = axes["dp"], rank_of(mesh, "dp")
    B, T, new = 2 * dp, 24, 4
    ids = np.random.RandomState(0).randint(0, vocab, (B, T))
    a, b = row_bounds(B, dp, dp_rank)
    pos = torch.arange(T + new)[None, None].expand(3, b - a, T + new)
    with torch.inference_mode():
        prompt = torch.from_numpy(ids[a:b])
        tokens, lengths, _ = greedy_generate(lm, lm.embed(prompt), pos[..., :T],
                                             max_new_tokens=new, eos_token_ids=(3,))
        _, hidden, _ = lm(lm.embed(torch.cat([prompt, tokens], 1)), pos, compute_logits=False)
        logits = lm._logits(hidden[:, T - 1:T - 1 + new])  # this rank's vocab columns
    parts = [None] * world
    dist.all_gather_object(parts, (dp_rank, rank_of(mesh, "tp"), tokens, lengths, logits))
    parts.sort(key=lambda p: p[:2])
    rows = [p for p in parts if p[1] == 0]
    # the vocab columns of a dp group's ranks in tp order (a whole lm_head:
    # every rank holds them all)
    cols = [[p[4] for p in parts if p[0] == d and (lm.head_start is not None or p[1] == 0)]
            for d in range(dp)]
    return {"tokens": torch.cat([p[2] for p in rows]), "lengths": torch.cat([p[3] for p in rows]),
            "logits": torch.cat([torch.cat(c, -1) for c in cols]), "mesh": axes}


def _synthetic_batch(policy, cfg, tmp: str) -> dict:
    """Two samples of a synthetic 28x28 store packed into one 256-token row
    (the JAX dryrun's batch)."""
    from internnav_tpu_torch.dataset.internvla_n1_dataset import (
        N1SampleDataset,
        n1_packed_collate_fn,
        tokenize_sample,
        write_synthetic_n1_dataset,
    )

    store = write_synthetic_n1_dataset(f"{tmp}/store.bin", n_episodes=2, T=6, hw=28)
    ds = N1SampleDataset(store, predict_step_nums=cfg.predict_step_nums, num_history=2)
    tpi = policy._tokens_per_image((28, 28))
    rows = []
    for s in ds:
        rows.append(tokenize_sample(s, policy.tokenizer, tokens_per_image=tpi,
                                    n_query=cfg.n_query))
        if len(rows) >= 2:
            break
    return n1_packed_collate_fn(rows, max_len=256, predict_step_nums=cfg.predict_step_nums)
