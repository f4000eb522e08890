"""The serving engine: continuous batching over a contiguous or paged cache
pool, counterpart of ``repro/serve/engine.py``.

``Engine.generate(requests)`` runs prefill-on-admit and a multi-token
decode loop:

* Admission: queued requests are grouped by prompt length (mixed-length
  prompts never pad each other); each group is prefilled in one batch, its
  first tokens sampled, and its cache rows and per-slot decode state
  written into free slots of the pool.
* Decode: between scheduler events the engine runs a chunk of up to
  ``decode_block`` decode+sample steps.  Tokens, positions, per-slot
  sampling streams and knobs stay on the device for the whole chunk; the
  host reads the chunk's tokens once at its end (no per-token sync).
* Retirement: at each sync the host checks EOS / max-token per slot,
  retires finished requests, and admits queued ones into the freed slots.

The cache is updated in place (the reference donates its buffers to the
jitted steps instead).  ``plan=`` with ``stage_params=`` serves the
partitions unjoined (``serve.staged``: the paper's stages deploy as they
were trained).  The sharded mode (``policy=``, a mesh of cards) is not
ported and raises.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.events import EventLog, default_log
from repro_torch.obs.metrics import DEPTH_BUCKETS, TTFT_MS_BUCKETS
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TID_LOOP, TID_REQ0, Tracer
from repro_torch.precision import PrecisionPolicy, get_policy
from repro_torch.serve import sampling, staged
from repro_torch.serve.api import Completion, Request, StreamEvent
from repro_torch.serve.kv_cache import (GARBAGE_BLOCK, CachePool,
                                        PagedCachePool, place_blocks,
                                        place_rows)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.tree import tree_map


# the block size the paged decode kernel takes (the CPU's plain path takes
# any)
CUDA_BLOCK_SIZE = 16


class Engine:
    """Serves one model (or one PartitionPlan stage chain) from resident
    params on one device.  One ``generate`` call at a time."""

    def __init__(self, cfg, params=None, *, seed: Optional[int] = None,
                 device="cuda", max_slots: int = 4, decode_block: int = 16,
                 plan=None, stage_params=None, policy=None, precision=None,
                 max_queue_wait_ms: Optional[float] = None,
                 max_cache_tokens: Optional[int] = None, clock=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 event_log: Optional[EventLog] = None, sleep=None,
                 paged: bool = False, block_size: int = 16):
        """device: where the engine runs; "cuda" (the default) raises when
        torch sees no card.  CPU tensors take the plain attention path,
        CUDA tensors the hand-written kernels.

        precision: optional preset name or PrecisionPolicy — activations
        and the cache pool run in its compute dtype.  The engine keeps one
        compute-dtype copy of the matmul weights and the embedding table
        (``models.model.compute_copy``), made once here, with the values
        the reference's per-op cast gives; norm scales stay fp32 and
        sampling always sees fp32 logits.

        plan, stage_params: a ``core.partition.PartitionPlan`` and its
        per-stage trees, served without a join (``serve.staged``); one
        compute-dtype copy is kept per stage tree.

        seed: random weights on explicit opt-in only, when neither
        ``params`` nor ``stage_params`` is given.  The remaining knobs are
        the reference's: see ``repro.serve.Engine``."""
        if (plan is None) != (stage_params is None):
            raise ValueError("pass plan= and stage_params= together")
        if params is not None and stage_params is not None:
            raise ValueError("pass either joined params= or staged "
                             "stage_params=, not both")
        if policy is not None:
            raise NotImplementedError(
                "sharded serving (policy=) is not ported: it needs the "
                "reference's launch.sharding.Policy on a mesh of cards")
        self.device = resolve_device(device)
        if precision is not None:
            cfg = get_policy(precision).apply_to_model(cfg)
        if self.device.type == "cuda":
            PrecisionPolicy(compute_dtype=cfg.dtype).apply_backend_flags()
            if paged and block_size != CUDA_BLOCK_SIZE:
                raise ValueError("the paged decode kernel takes "
                                 f"{CUDA_BLOCK_SIZE}-token blocks, got "
                                 f"block_size={block_size}")
        if params is None and stage_params is None:
            if seed is None:
                raise ValueError("pass params= / stage_params=, or seed= to "
                                 "explicitly serve random-init weights")
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen)
        self.cfg = cfg
        self.plan = plan

        def resident(tree):
            return M.compute_copy(tree_map(lambda t: t.to(self.device), tree),
                                  cfg.activation_dtype())
        self.params = resident(params) if plan is None \
            else [resident(sp) for sp in stage_params]
        self.max_slots = max_slots
        self.decode_block = decode_block
        self.paged = paged
        self.block_size = block_size
        self._pool = None                   # grow-only, one per engine
        self.scheduler: Optional[Scheduler] = None
        self.max_queue_wait_ms = max_queue_wait_ms
        self.max_cache_tokens = max_cache_tokens
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self._clock)
        self.event_log = event_log if event_log is not None else default_log()
        self.bind_metrics(metrics if metrics is not None
                          else MetricsRegistry())

    def bind_metrics(self, metrics: MetricsRegistry) -> None:
        """(Re-)home the engine's series in ``metrics``."""
        self.metrics = metrics
        self._rejected = metrics.counter(
            "serve_rejected_total",
            help="requests shed, by reason (cache/queue/deadline)")
        self._requests = metrics.counter(
            "serve_requests_total", help="completions, by finish reason")
        self._tokens = metrics.counter(
            "serve_tokens_total", help="generated tokens (incl. partial)")
        self._ttft = metrics.histogram(
            "serve_ttft_ms", TTFT_MS_BUCKETS,
            help="submit -> first sampled token, ms")
        self._queue_depth = metrics.histogram(
            "serve_queue_depth", DEPTH_BUCKETS,
            help="wait-queue depth sampled at each decode sync")
        self._slots_busy = metrics.histogram(
            "serve_slots_busy", DEPTH_BUCKETS,
            help="active slots sampled at each decode sync")
        self._peak_slots = metrics.gauge(
            "serve_peak_slots_busy", help="max concurrent active slots")
        self._cache_tokens = metrics.gauge(
            "serve_cache_tokens", help="cache-pool length, tokens per slot")
        if self.paged:
            self._blocks_busy = metrics.histogram(
                "serve_blocks_busy", DEPTH_BUCKETS,
                help="allocated cache blocks sampled at each decode sync")
            self._peak_blocks = metrics.gauge(
                "serve_peak_blocks_busy",
                help="max concurrently allocated cache blocks")
            self._prefix_hits = metrics.counter(
                "serve_prefix_hits_total",
                help="prompt blocks reused via shared-prefix registry")

    @property
    def stats(self) -> Dict[str, int]:
        """Degraded-mode telemetry, cumulative across ``generate()`` calls."""
        return {"rejected_cache": self._rejected.value(reason="cache"),
                "rejected_queue": self._rejected.value(reason="queue"),
                "rejected_deadline": self._rejected.value(reason="deadline")}

    # -- forward fns (joined or staged) --------------------------------------

    def _prefill_fn(self, batch, cache_len):
        if self.plan is not None:
            return staged.staged_prefill(self.cfg, self.plan, self.params,
                                         batch, cache_len)
        return M.prefill(self.cfg, self.params, batch, cache_len)

    def _decode_fn(self, cache, tok, pos, paged=None):
        if self.plan is not None:
            return staged.staged_decode_step(self.cfg, self.plan,
                                             self.params, cache, tok, pos,
                                             paged=paged)
        return M.decode_step(self.cfg, self.params, cache, tok, pos,
                             paged=paged)

    # -- device steps --------------------------------------------------------

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.device)

    def _admit_step(self, state, pool, batch, cache_len, mode, slots, reqs,
                    write_rows=None):
        """Prefill one same-length group, sample its first tokens (stream
        step 0) and write its cache rows and per-slot state, in place.
        Returns the group's first tokens (on the device)."""
        logits, group_cache, p1 = self._prefill_fn(batch, cache_len)
        g = {"seeds": self._tensor([r.gen.seed for r in reqs], torch.int64),
             "temps": self._tensor([r.gen.temperature for r in reqs],
                                   torch.float32),
             "tks": self._tensor([r.gen.top_k for r in reqs], torch.int64),
             "tps": self._tensor([r.gen.top_p for r in reqs], torch.float32)}
        vs = self.cfg.vocab_size
        t0 = sampling.sample_tokens(
            logits[:, :vs].float(), g["seeds"],
            torch.zeros_like(g["seeds"]), g["temps"], g["tks"], g["tps"],
            mode=mode)
        sl = self._tensor(slots, torch.int64)
        if write_rows is not None:
            place_blocks(pool.cache, group_cache, sl,
                         self._tensor(write_rows, torch.int64),
                         block_size=self.block_size)
        else:
            place_rows(pool.cache, group_cache, sl)
        state["tok"][sl] = t0
        state["pos"][sl] = p1
        state["steps"][sl] = 1
        for name in ("seeds", "temps", "tks", "tps"):
            state[name][sl] = g[name]
        return t0

    def _decode_chunk(self, state, pool, n, mode, tables=None, lc=None):
        """n decode+sample steps on the device; returns the (n, n_slots)
        token tensor (still on the device)."""
        vs = self.cfg.vocab_size
        paged = None
        if tables is not None:
            paged = (self._tensor(tables, torch.int32), lc)
        toks = torch.empty((n, self.max_slots), dtype=torch.int32,
                           device=self.device)
        for i in range(n):
            logits, _ = self._decode_fn(pool.cache, state["tok"],
                                        state["pos"], paged=paged)
            state["tok"] = sampling.sample_tokens(
                logits[:, :vs].float(), state["seeds"], state["steps"],
                state["temps"], state["tks"], state["tps"], mode=mode)
            state["pos"] += 1
            state["steps"] += 1
            toks[i] = state["tok"]
        return toks

    # -- request plumbing ----------------------------------------------------

    def _request_batch(self, reqs: Sequence[Request]):
        """Batch for a group of same-length prompts; an encoder-decoder's
        carries each request's ``frames`` as (enc_seq, d_model), zeros
        where a request has none.  Admission then writes the group's cross
        K/V into its slots' rows, as every leaf that is not paged.  A
        vision config's carries each request's ``image_embeds`` as
        (vision_tokens, d_model) the same way, zeros where it has none."""
        cfg = self.cfg
        toks = np.stack([np.asarray(r.tokens, np.int64).reshape(-1)
                         for r in reqs])
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if cfg.enc_dec:
            shape = (cfg.enc_seq, cfg.d_model)
            batch["frames"] = torch.stack([
                torch.zeros(shape, dtype=torch.float32, device=self.device)
                if r.frames is None else
                torch.as_tensor(r.frames).reshape(shape).to(self.device,
                                                            torch.float32)
                for r in reqs])
        if cfg.frontend == "vision":
            shape = (cfg.vision_tokens, cfg.d_model)
            batch["image_embeds"] = torch.stack([
                torch.zeros(shape, dtype=torch.float32, device=self.device)
                if r.image_embeds is None else
                torch.as_tensor(r.image_embeds).reshape(shape).to(
                    self.device, torch.float32)
                for r in reqs])
        return batch

    def _prefix_rows(self) -> int:
        """Cache rows a request holds before its prompt: a vision config's
        image rows, else none."""
        return self.cfg.vision_tokens if self.cfg.frontend == "vision" else 0

    def _cache_len_for(self, requests: Sequence[Request]) -> int:
        return max(len(np.asarray(r.tokens).reshape(-1))
                   + r.gen.max_new_tokens for r in requests) \
            + self._prefix_rows()

    def _pool_for(self, need_len: int):
        """The engine's single cache pool, grow-only and bucketed to 32
        tokens."""
        if self.max_cache_tokens is not None:
            need_len = min(need_len, self.max_cache_tokens)
        if self._pool is None or self._pool.cache_len < need_len:
            size = -(-need_len // 32) * 32
            self._pool = None               # free the old pool first
            if self.paged:
                self._pool = PagedCachePool(
                    self.cfg, self.max_slots, size,
                    block_size=self.block_size,
                    max_tokens=self.max_cache_tokens, device=self.device)
            else:
                self._pool = CachePool(self.cfg, self.max_slots, size,
                                       device=self.device)
        return self._pool

    def _chunk_len(self, remaining: int) -> int:
        """Steps until the next sync: the nearest guaranteed retirement,
        rounded up to a power of two (overshoot is truncated at the sync)."""
        if remaining >= self.decode_block:
            return self.decode_block
        return min(1 << max(remaining - 1, 0).bit_length(), self.decode_block)

    # -- the loop ------------------------------------------------------------

    def generate(self, requests: Sequence[Request],
                 cache_len: Optional[int] = None,
                 arrivals: Optional[Sequence[float]] = None
                 ) -> List[Completion]:
        """Continuously-batched generation; completions in request order.
        ``arrivals``: optional per-request submission offsets in seconds
        (open-loop traffic)."""
        done: Dict[int, Completion] = {}
        for ev in self.stream(requests, cache_len=cache_len,
                              arrivals=arrivals):
            if ev.kind == "done":
                done[ev.req_idx] = ev.completion
        return [done[i] for i in range(len(requests))]

    def stream(self, requests: Sequence[Request],
               cache_len: Optional[int] = None,
               arrivals: Optional[Sequence[float]] = None
               ) -> Iterator[StreamEvent]:
        """Streaming form of ``generate``: a "delta" event per generated
        token and one "done" event per request with its ``Completion``."""
        if not requests:
            return
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError("arrivals must align 1:1 with requests")
        n_slots = self.max_slots
        extra = self._prefix_rows()

        def span(r) -> int:
            return np.asarray(r.tokens).reshape(-1).shape[0] \
                + r.gen.max_new_tokens + extra

        def completion(r, tokens, reason) -> Completion:
            self._requests.inc(1, reason=reason)
            return Completion(
                id=r.id,
                prompt_tokens=tuple(int(t) for t in
                                    np.asarray(r.tokens).reshape(-1)),
                tokens=tokens, finish_reason=reason)

        sched = self.scheduler = Scheduler(
            n_slots, max_queue_wait_ms=self.max_queue_wait_ms,
            event_log=self.event_log)
        paged = self.paged
        done: Dict[int, Completion] = {}
        evq: List[StreamEvent] = []

        def flush() -> List[StreamEvent]:
            out = evq[:]
            evq.clear()
            return out

        def ev_done(req_idx: int, r, comp: Completion) -> None:
            done[req_idx] = comp
            evq.append(StreamEvent("done", req_idx, r.id, completion=comp))

        accepted: List[Request] = []
        now0 = self._clock()
        self.event_log.emit("generate_begin", n=len(requests))
        for i, r in enumerate(requests):
            if self.max_cache_tokens is not None \
                    and span(r) > self.max_cache_tokens:
                ev_done(i, r, completion(r, (), "rejected"))
                self._rejected.inc(1, reason="cache")
                self.event_log.emit("reject", req=i)
            elif r.gen.max_new_tokens <= 0:
                ev_done(i, r, completion(r, (), "length"))
            else:
                t = now0 + (arrivals[i] if arrivals is not None else 0.0)
                sched.submit(i, r, t)
                accepted.append(r)
        yield from flush()
        if not accepted:
            self.event_log.emit("generate_end", n=len(requests))
            return
        pool = self._pool_for(max(cache_len or 0,
                                  self._cache_len_for(accepted)))
        cache_len = pool.cache_len
        tables = lc = None
        if paged:
            # host-side block tables, garbage-padded; free slots stay
            # all-garbage so their ignored decode writes land in block 0
            tables = np.zeros((n_slots, pool.blocks_per_slot), np.int32)
            lc = pool.attn_len

        def zeros(dtype):
            return torch.zeros((n_slots,), dtype=dtype, device=self.device)
        state = {"tok": zeros(torch.int32), "pos": zeros(torch.int32),
                 "seeds": zeros(torch.int64), "steps": zeros(torch.int64),
                 "temps": zeros(torch.float32), "tks": zeros(torch.int64),
                 "tps": torch.ones((n_slots,), dtype=torch.float32,
                                   device=self.device)}

        mode = sampling.mode_for([r.gen for r in requests])
        shedding = self.max_queue_wait_ms is not None or any(
            r.deadline_ms is not None for r in accepted)
        open_loop = arrivals is not None
        admit_t: Dict[int, float] = {}

        def finish(slot: int, reason: str) -> None:
            st = sched.retire(slot)
            st.finish_reason = reason
            ev_done(st.req_idx, st.request,
                    completion(st.request, tuple(st.emitted), reason))
            if paged and st.blocks is not None:
                pool.release(st.blocks)
                tables[slot] = GARBAGE_BLOCK
                st.blocks = None
            self._tokens.inc(len(st.emitted))
            t_adm = admit_t.pop(st.req_idx, None)
            if t_adm is not None:
                self.tracer.add_span(
                    f"req {st.req_idx} active", t_adm,
                    self._clock() - t_adm, cat="request",
                    tid=TID_REQ0 + st.req_idx, reason=reason,
                    tokens=len(st.emitted))

        def shed() -> None:
            """Reject queued requests past their wait budget and active
            slots past their deadline (partial tokens kept)."""
            if not shedding:
                return
            now = self._clock()
            for req_idx, r in sched.expire_queued(now):
                ev_done(req_idx, r, completion(r, (), "rejected"))
                self._rejected.inc(1, reason="queue")
                self.tracer.instant(f"req {req_idx} shed", ts=now,
                                    cat="request", tid=TID_REQ0 + req_idx)
            for slot in sched.overdue_active(now):
                finish(slot, "rejected")
                self._rejected.inc(1, reason="deadline")

        def admit_group(items, allocs=None) -> None:
            reqs = [r for _, r, _ in items]
            batch = self._request_batch(reqs)
            t_adm = self._clock()
            slots = [sched.admit(i, r, batch["tokens"].shape[1], arrival=t)
                     for i, r, t in items]
            wrows = None
            if paged:
                wrows = []
                for slot, alloc in zip(slots, allocs):
                    sched.active[slot].blocks = alloc.ids
                    tables[slot] = pool.table_row(alloc)
                    wrows.append(pool.write_row(alloc))
                    if alloc.n_shared:
                        self._prefix_hits.inc(alloc.n_shared)
            for i, _, t in items:
                admit_t[i] = t_adm
                self.tracer.add_span(f"req {i} queued", t, t_adm - t,
                                     cat="request", tid=TID_REQ0 + i)
            with self.tracer.span("admit", cat="serve", tid=TID_LOOP,
                                  batch=len(reqs)):
                t0 = self._admit_step(state, pool, batch, cache_len, mode,
                                      slots, reqs, write_rows=wrows)
                t0h = t0.cpu().numpy()       # the sync: first tokens are real
            now = self._clock()
            for _, _, t in items:
                self._ttft.observe((now - t) * 1000.0)
            for row, (slot, (i, r, _)) in enumerate(zip(slots, items)):
                g = r.gen
                tv = int(t0h[row])
                sched.active[slot].emitted.append(tv)
                evq.append(StreamEvent("delta", i, r.id, token=tv))
                if g.eos_id is not None and tv == g.eos_id:
                    finish(slot, "eos")
                elif g.max_new_tokens <= 1:
                    finish(slot, "length")

        def admit_ready() -> None:
            now = self._clock() if open_loop else None
            while sched.queued() and sched.free:
                take = sched.take(len(sched.free), now=now)
                if not take:
                    break
                stalled = False
                groups: Dict[int, list] = {}
                if paged:
                    # reserve each request's blocks before it reaches a
                    # slot; when blocks run out the tail goes back to the
                    # queue head and waits for the next retirement
                    for j, (i, r, t) in enumerate(take):
                        ptoks = np.asarray(r.tokens,
                                           np.int64).reshape(-1).tolist()
                        alloc = pool.allocate(ptoks, span(r))
                        if alloc is None:
                            if pool.allocator.n_used == 0:
                                # can never fit the block budget: shed it
                                ev_done(i, r, completion(r, (), "rejected"))
                                self._rejected.inc(1, reason="cache")
                                self.event_log.emit("reject", req=i)
                                continue
                            sched.requeue_front(take[j:])
                            stalled = True
                            break
                        plen = len(ptoks)
                        groups.setdefault(plen, []).append(((i, r, t), alloc))
                    for pairs in groups.values():
                        admit_group([it for it, _ in pairs],
                                    [al for _, al in pairs])
                else:
                    for i, r, t in take:
                        plen = np.asarray(r.tokens).reshape(-1).shape[0]
                        groups.setdefault(plen, []).append((i, r, t))
                    for items in groups.values():
                        admit_group(items)
                if stalled:
                    break

        shed()
        admit_ready()
        yield from flush()
        while sched.active or sched.queued():
            if not sched.active:
                na = sched.next_arrival()
                if na is None:
                    break
                gap = na - self._clock()
                if gap > 0:
                    self._sleep(gap)
                shed()
                admit_ready()
                yield from flush()
                continue
            self._queue_depth.observe(sched.queued())
            self._slots_busy.observe(len(sched.active))
            if paged:
                self._blocks_busy.observe(pool.allocator.n_used)
            n = self._chunk_len(sched.min_remaining())
            with self.tracer.span(f"decode[{n}]", cat="serve", tid=TID_LOOP,
                                  active=len(sched.active), steps=n):
                toks = self._decode_chunk(state, pool, n, mode,
                                          tables=tables, lc=lc)
                toks_h = toks.cpu().numpy()           # one sync per chunk
            for slot in list(sched.active):
                st = sched.active[slot]
                eos = st.request.gen.eos_id
                for t in toks_h[:, slot]:
                    tv = int(t)
                    st.emitted.append(tv)
                    evq.append(StreamEvent("delta", st.req_idx,
                                           st.request.id, token=tv))
                    if eos is not None and tv == eos:
                        finish(slot, "eos")
                        break
                    if st.remaining <= 0:
                        finish(slot, "length")
                        break
            shed()
            admit_ready()
            yield from flush()
        self._peak_slots.set_max(sched.max_concurrent)
        self._cache_tokens.set(pool.cache_len)
        if paged:
            self._peak_blocks.set_max(pool.allocator.peak_used)
        self.metrics.drain()
        self.event_log.emit("generate_end", n=len(requests),
                            completed=len(done))
        yield from flush()
