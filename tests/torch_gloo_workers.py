"""Workers that the CPU tests spawn in gloo process groups. This module
imports neither JAX nor the test modules, so a spawned child loads only
torch and the port."""

import numpy as np
import torch
import torch.distributed as dist


def collectives_worker(rank: int, world: int, port: int, out: str) -> None:
    """Every helper of `parallel.collectives` and `parallel.mesh.shard_batch`
    on a dp x tp = 2 x 2 mesh; this rank's results saved to out/rank{r}.pt."""
    from internnav_tpu_torch import parallel
    from internnav_tpu_torch.parallel.collectives import comm_device, mesh_group, pmax, psum_forward

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
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


def serve_tp_worker(rank: int, world: int, port: int, spec_path: str, out: str) -> None:
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
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
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
