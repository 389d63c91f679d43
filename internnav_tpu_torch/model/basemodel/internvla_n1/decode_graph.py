"""The greedy decode loop, with its state on the device and, on CUDA, each
step a replay of a captured CUDA graph.

The JAX package runs the loop as one `lax.while_loop` program
(qwen_text.py `greedy_generate`, `greedy_decode_grouped`). Run eagerly,
every step of the 7B decoder is some 360 launches through Python
wrappers, and the host, not the card, sets the pace. Here the step is
captured once and replayed:

- `StaticCaches`: the KV cache buffers of one group of rows, allocated
  once (zero-filled) and reused across requests; the prefill writes its
  K/V into them (`QwenTextModel.forward(caches_out=)`).
- `DecodeLoop`: the static inputs of the step (tokens (B, max_new_tokens),
  the prompt lengths, rope deltas, a step counter, the done flags and
  their all-done flag, all on the device) and, on CUDA, two captured
  graphs of one step over its cache groups: with the lm_head and the
  token write, and without them for the last step (the JAX loop skips the
  logits there; a one-token loop has only this one). `run` replays them
  in chunks of DECODE_CHUNK steps; before it enqueues the next chunk it
  reads the previous chunk's all-done flag through a pinned buffer and an
  event. On the CPU the same step runs eagerly with the same chunked
  check.
- `DecodeBuffers`: the caches and loops a policy owns. Caches are pooled
  by compute shape (rows, Tmax, format): a caller acquires a free set for
  its prefill and releases it once the latent chunk is enqueued. Sets of
  one shape go out in the same order whenever a layout recurs, so a
  decode over them finds the loop (keyed by the sets) it captured before,
  whichever cohorts prefilled them. Both are bounded, the least recently
  used going first.

Steps past the one where every row is done change no result: a done row
writes EOS as its next token (`where(done, eos, next)`), and the K/V a
step writes lands at slot prompt_length + step, past the row's generated
length; the traj-latent chunk writes its n_query slots from prompt_length
+ length on before it attends to them, and no query attends past its own
slot, so a slot written past the end is overwritten or never read.

Under the serving layout (`parallel/tp.apply_serve_tp`) a step holds the
tp group's collectives: the row-parallel all-reduces and the vocab
argmax's two (`QwenTextModel.greedy_token`), so every rank of the group
feeds the same tokens and stops at the same chunk. A captured step holds
NCCL's launches and its replays run them (held bitwise against the
unsharded loop on the card at world size 1). A gloo group (the CPU, or
ranks that share one card) reduces on the host, which no graph can hold:
a loop over a model whose tp group is not NCCL's runs its step eagerly on
the card too (`capturable`; counted as `eager_uncapturable` in `stats`).

Launch counts: a captured launch does not run, so the kernel wrappers'
counters are put back after a capture, and each replay adds the launches
its graph captured, so that the counters still count launches on the
device. `stats` counts the steps run (with and without the lm_head),
replays, captures and warm-up steps.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch

#: decode steps a chunk of replays; the host reads the all-done flag
#: between chunks
DECODE_CHUNK = 8
#: cache sets and loops a `DecodeBuffers` keeps (sets in use are never
#: dropped)
MAX_CACHES = 64
MAX_LOOPS = 64

#: steps run on the device (graph replays, eager and warm-up steps), those
#: of them with the lm_head, graph replays, captures (one per graph),
#: warm-up steps, and CUDA loops left eager because their model's
#: collectives cannot be captured
stats = collections.Counter()


def reset_stats() -> None:
    stats.clear()


def _counter_modules():
    from internnav_tpu_torch.ops import activations, flash_attention, quant

    return (activations, flash_attention, quant)


def launch_counters() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch counter, by (module, name)."""
    return {(m.__name__, name): getattr(m, name)
            for m in _counter_modules() for name in m.LAUNCH_COUNTERS}


def _add_launches(delta: Dict[Tuple[str, str], int]) -> None:
    for m in _counter_modules():
        for name in m.LAUNCH_COUNTERS:
            if delta.get((m.__name__, name)):
                setattr(m, name, getattr(m, name) + delta[(m.__name__, name)])


def capturable(model) -> bool:
    """Whether a CUDA graph may hold a decode step of model: it has no
    serving tp group, or that group is NCCL's (a gloo group reduces on the
    host)."""
    group = getattr(model, "tp_group", None)
    if group is None:
        return True
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


def stop_mask(tokens: torch.Tensor, eos: torch.Tensor) -> torch.Tensor:
    """tokens (...) in the stop ids eos (E,), on the device of tokens."""
    return (tokens[..., None] == eos).any(-1)


class StaticCaches:
    """The per-layer KV cache of `rows` rows and Tmax slots: (k, v) entries
    of bf16 (rows, Tmax, KV, D), or with kv_dtype="int8" (int8 (rows,
    Tmax, KV, D), fp32 (rows, Tmax, KV, 1)) tuples; zero-filled once, so
    that a slot never written holds finite values."""

    def __init__(self, cfg, rows: int, Tmax: int, device):
        L, KV, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim

        def entry():
            if cfg.kv_dtype == "int8":
                return (torch.zeros((rows, Tmax, KV, D), dtype=torch.int8, device=device),
                        torch.zeros((rows, Tmax, KV, 1), dtype=torch.float32, device=device))
            return torch.zeros((rows, Tmax, KV, D), dtype=cfg.dtype, device=device)

        self.rows, self.Tmax = rows, Tmax
        self.entries = [(entry(), entry()) for _ in range(L)]


class DecodeLoop:
    """The greedy decode loop over cache groups (see the module doc)."""

    def __init__(self, model, groups: Sequence[StaticCaches], max_new_tokens: int,
                 eos_token_ids: Sequence[int], *, eager: bool = False):
        self.model, self.groups = model, list(groups)
        self.max_new_tokens = int(max_new_tokens)
        dev = cache_device(self.groups)
        B = sum(g.rows for g in self.groups)
        self.eos = torch.as_tensor(tuple(eos_token_ids), dtype=torch.long, device=dev)
        self.tokens = torch.full((B, self.max_new_tokens), int(eos_token_ids[0]),
                                 dtype=torch.long, device=dev)
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)
        self.all_done = torch.zeros(1, dtype=torch.bool, device=dev)
        self.prompt_lengths = torch.zeros(B, dtype=torch.long, device=dev)
        self.rope_deltas = torch.zeros(B, dtype=torch.long, device=dev)
        self.graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        if dev.type == "cuda" and not eager:
            if capturable(model):
                self._flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
                self._event = torch.cuda.Event()
                self._capture(dev)
            else:
                stats["eager_uncapturable"] += 1

    # ------------------------------------------------------------ the step
    def _step(self, logits: bool) -> None:
        """One decode step on the static state: feed tokens[:, step] (the
        done flags take it in first), write its K/V, and with `logits` put
        the next token at step + 1; then step += 1. Reads only device
        tensors."""
        model, B = self.model, self.tokens.shape[0]
        idx = self.step.view(1, 1).expand(B, 1)
        cur = self.tokens.gather(1, idx)
        done = self.done | stop_mask(cur[:, 0], self.eos)
        self.done.copy_(done)
        self.all_done.copy_(done.all().view(1))
        pos = (self.prompt_lengths + self.rope_deltas + self.step)[None, :, None].expand(3, B, 1)
        cache_len = self.prompt_lengths + self.step
        lens = cache_len.split([g.rows for g in self.groups])
        _, hidden, _ = model.decode_step_grouped(model.embed(cur), pos,
                                                 [g.entries for g in self.groups], lens,
                                                 compute_logits=False)
        if logits:
            nxt = model.greedy_token(model._logits(hidden, decode=True))
            self.tokens.scatter_(1, idx + 1, torch.where(done, self.eos[0], nxt)[:, None])
        self.step.add_(1)

    def _capture(self, dev) -> None:
        """One warm-up step on a side stream (it loads the kernels and
        builds their tables; its launches run and count), then a capture
        of each step variant the loop runs into one memory pool: with the
        lm_head only when there is a token step + 1 to write (the tokens
        buffer has max_new_tokens columns). The warm-up feeds token id 0
        and writes each group's last cache slot, which no request reads
        before it writes it. A failed capture raises."""
        variants = (True, False) if self.max_new_tokens > 1 else (False,)
        r = 0
        for g in self.groups:
            self.prompt_lengths[r:r + g.rows] = g.Tmax - 1
            r += g.rows
        self.tokens.zero_()  # a stop id may be no token (bench pins one)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step(variants[0])
        torch.cuda.current_stream(dev).wait_stream(side)
        stats["warmup_steps"] += 1
        stats["steps"] += 1
        stats["logits_steps"] += int(variants[0])
        pool = None
        for logits in variants:
            before = launch_counters()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self._step(logits)
            after = launch_counters()
            delta = {k: after[k] - before[k] for k in after}
            _add_launches({k: -d for k, d in delta.items()})  # a capture launches nothing
            self.graphs[logits] = (graph, delta)
            pool = graph.pool()
            stats["captures"] += 1

    def _run_step(self, logits: bool) -> None:
        if self.graphs:
            graph, delta = self.graphs[logits]
            graph.replay()
            _add_launches(delta)
            stats["replays"] += 1
        else:
            self._step(logits)
        stats["steps"] += 1
        stats["logits_steps"] += int(logits)

    def _all_done(self) -> bool:
        """The all-done flag of the last enqueued step: through a pinned
        buffer and an event on CUDA (the host waits for that step alone)."""
        if not self.graphs:
            return bool(self.all_done[0])
        self._flag.copy_(self.all_done, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return bool(self._flag[0])

    # ----------------------------------------------------------------- run
    def run(self, first_tok, prompt_lengths, rope_deltas):
        """Decode from first_tok (B,) with the caches holding each row's
        prompt: token t of a row is fed at cache slot prompt_lengths + t,
        position prompt_lengths + rope_deltas + t. Returns (tokens (B,
        max_new_tokens), lengths (B,)), new tensors the caller keeps."""
        self.tokens.copy_(self.eos[0].expand_as(self.tokens))
        self.tokens[:, 0] = first_tok
        self.step.zero_()
        self.done.zero_()
        self.all_done.zero_()
        self.prompt_lengths.copy_(prompt_lengths)
        self.rope_deltas.copy_(rope_deltas)
        n = self.max_new_tokens
        s = 0
        while s < n:
            for i in range(s, min(s + DECODE_CHUNK, n)):
                self._run_step(logits=i + 1 < n)
            s = min(s + DECODE_CHUNK, n)
            if s < n and self._all_done():
                break
        self.steps_run = s
        tokens = self.tokens.clone()
        hit = stop_mask(tokens, self.eos)
        lengths = torch.where(hit.any(1), hit.int().argmax(1),
                              torch.full_like(self.prompt_lengths, n))
        return tokens, lengths


class DecodeBuffers:
    """The static caches and decode loops of one owner (a policy). Cache
    sets are pooled by compute shape: `acquire` hands out the first free
    set of a shape (in the order the sets were made) and `release` takes
    it back. Loops are keyed by their groups' sets. At most MAX_CACHES
    sets (sets in use are never dropped) and MAX_LOOPS loops are kept, the
    least recently used dropped first (a set with the loops over it)."""

    def __init__(self):
        self._sets: Dict[tuple, List[StaticCaches]] = {}
        self._recent: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._busy: set = set()
        self._loops: "collections.OrderedDict" = collections.OrderedDict()

    @staticmethod
    def _shape(cfg, rows: int, Tmax: int, device) -> tuple:
        return (int(rows), int(Tmax), cfg.num_hidden_layers, cfg.num_key_value_heads,
                cfg.head_dim, cfg.kv_dtype, cfg.dtype, str(torch.device(device)))

    def acquire(self, cfg, rows: int, Tmax: int, device) -> StaticCaches:
        """A free cache set of `rows` rows and Tmax slots in cfg's format on
        device, made when none is free; the caller's until `release`."""
        shape = self._shape(cfg, rows, Tmax, device)
        hit = next((c for c in self._sets.get(shape, ()) if id(c) not in self._busy), None)
        if hit is None:
            while len(self._recent) >= MAX_CACHES and self._drop_lru():
                pass
            hit = StaticCaches(cfg, rows, Tmax, device)
            self._sets.setdefault(shape, []).append(hit)
        self._busy.add(id(hit))
        self._recent.pop(id(hit), None)
        self._recent[id(hit)] = shape  # (re)inserted last: least recently used first
        return hit

    def release(self, caches: StaticCaches) -> None:
        self._busy.discard(id(caches))

    def _drop_lru(self) -> bool:
        """Drop the least recently acquired free set and its loops; False
        when every set is in use."""
        key = next((k for k in self._recent if k not in self._busy), None)
        if key is None:
            return False
        shape = self._recent.pop(key)
        self._sets[shape] = [c for c in self._sets[shape] if id(c) != key]
        if not self._sets[shape]:
            del self._sets[shape]
        for k in [k for k, loop in self._loops.items()
                  if any(id(g) == key for g in loop.groups)]:
            del self._loops[k]
        return True

    def loop(self, model, groups: List[StaticCaches], max_new_tokens: int,
             eos_token_ids: Sequence[int], *, eager: bool = False) -> DecodeLoop:
        """The loop over these cache groups (by identity), made (and on CUDA
        captured) when missing. The key holds the model's weight and decode
        formats and its serving layout's tp group: a captured step launches
        the kernels and collectives it was captured with."""
        key = (tuple(id(g) for g in groups), int(max_new_tokens), tuple(eos_token_ids),
               bool(eager), id(model), model.cfg.weight_dtype, model.cfg.decode_act_dtype,
               id(model.tp_group))
        hit = self._loops.pop(key, None)
        if hit is None:
            while len(self._loops) >= MAX_LOOPS:
                self._loops.popitem(last=False)
            hit = DecodeLoop(model, groups, max_new_tokens, eos_token_ids, eager=eager)
        self._loops[key] = hit
        return hit


def cache_device(groups: Sequence[StaticCaches]) -> torch.device:
    """The device of the first group's caches."""
    e = groups[0].entries[0][0]
    return (e[0] if isinstance(e, tuple) else e).device
