"""Decode cache pools: contiguous slots and block-paged allocation
(counterpart of ``repro/serve/kv_cache.py``; the pools live on a torch
device and admission writes into them in place).

Two pool flavors share the ``(G, B, ...)`` leaf layout from
``models.model.init_cache``:

* ``CachePool`` — the slot-contiguous pool: one full ``cache_len`` row per
  slot.  Admitting a request writes its prefill cache rows into free slots
  via ``place_rows``.
* ``PagedCachePool`` — vLLM-style block paging over the same layouts.  The
  attention K/V leaves become ``(G, n_blocks, block_size, KV, hd)`` pools
  of fixed-size token blocks; a host-side ``BlockAllocator`` hands out
  refcounted physical blocks and per-request block tables, so a short
  request pins ``ceil(span / block_size)`` blocks instead of a whole
  max-length row and ``max_cache_tokens`` becomes an exact total-token
  budget.  Shared-prefix
  reuse: the allocator keeps a registry of fully-filled prompt blocks
  keyed by their token prefix — a request whose prompt starts with a
  registered prefix increfs those blocks instead of re-prefilling them
  into fresh ones (the engine routes the duplicate writes to the reserved
  garbage block, so the first writer's values are the shared truth).

Physical block 0 is reserved as the **garbage block**: unallocated block-
table entries point at it, scatters for masked-off logical blocks land in
it, and no reader ever sees it (the ``slot <= pos`` validity mask in
decode attention covers exactly the allocated logical span).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.precision import tree_bytes

GARBAGE_BLOCK = 0
# cache leaf names that page over token blocks; everything else (recurrent
# carries, cross-attention KV) is O(1) per request and stays slot-resident
PAGED_LEAVES = ("k", "v")
# bounded shared-prefix registry (FIFO eviction) — correctness never
# depends on an entry surviving, only on live entries being valid
PREFIX_REGISTRY_CAP = 512


def place_rows(pool_cache, group_cache, slots):
    """Write the rows of a prefilled group cache into pool slots ``slots``
    ((R,) int tensor; batch axis is 1 under the group stack), in place.
    Full overwrite: a reused slot never leaks its predecessor."""
    for sk, grp in pool_cache.items():
        for name, p in grp.items():
            p[:, slots] = group_cache[sk][name].to(p.dtype)
    return pool_cache


def place_blocks(pool_cache, group_cache, slots, write_rows, *,
                 block_size: int):
    """Paged admission write, in place.

    Attention K/V leaves of ``group_cache`` ((G, R, lc, KV, hd)) are padded
    to whole blocks and written to the physical blocks in ``write_rows``
    ((R, nb) int tensor; shared-prefix blocks point at the garbage block so
    the first writer's values survive); every other leaf row-writes into
    ``slots`` exactly like ``place_rows``."""
    r, nb = write_rows.shape
    flat = write_rows.reshape(-1).long()
    for sk, grp in pool_cache.items():
        for name, p in grp.items():
            gc = group_cache[sk][name]
            if name in PAGED_LEAVES:
                g, _, lc = gc.shape[:3]
                pad = nb * block_size - lc
                if pad:
                    gc = torch.nn.functional.pad(gc, (0, 0, 0, 0, 0, pad))
                gc = gc.reshape(g, r * nb, block_size, *p.shape[3:])
                p[:, flat] = gc.to(p.dtype)
            else:
                p[:, slots] = gc.to(p.dtype)
    return pool_cache


class CachePool:
    """Owns the decode cache for up to ``n_slots`` in-flight requests, one
    contiguous ``cache_len`` row per slot.  Placement happens via
    ``place_rows`` in the engine's admission step; this class owns
    allocation and sizing."""

    def __init__(self, cfg, n_slots: int, cache_len: int, *, device):
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        # K/V and conv leaves follow cfg.dtype (the precision policy's
        # compute dtype — bf16 halves them); the ssm state stays fp32.
        # ``device`` has no default: the pool is never placed on the CPU by
        # omission.
        self.cache = M.init_cache(cfg, n_slots, cache_len, device=device)

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool (dtype-aware memory accounting)."""
        return tree_bytes(self.cache)


# --------------------------------------------------------------------------
# block-paged pool
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PagedAlloc:
    """One request's block allocation: ``ids`` in logical-block order (the
    first ``n_shared`` increfed from the shared-prefix registry, the rest
    freshly owned)."""
    ids: Tuple[int, ...]
    n_shared: int


class BlockAllocator:
    """Host-side refcounted allocator over physical cache blocks.

    Block 0 is the reserved garbage block — never allocated, never freed.
    ``gen`` counts how many times a block has been returned to the free
    pool; the shared-prefix registry snapshots it so stale entries (block
    recycled under a new owner) are detected on lookup.  ``check()``
    mirrors the scheduler's slot-leak discipline: every block is either
    free with refcount 0 or live with refcount > 0, exactly once."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the garbage "
                             f"block), got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.refcount: List[int] = [0] * n_blocks
        self.gen: List[int] = [0] * n_blocks
        self.free_list: Deque[int] = deque(range(1, n_blocks))
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self.free_list)

    @property
    def n_used(self) -> int:
        return (self.n_blocks - 1) - self.n_free

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks (refcount 1 each), or None if not enough free —
        all-or-nothing, so a failed admission never holds partial blocks."""
        if n > len(self.free_list):
            return None
        ids = [self.free_list.popleft() for _ in range(n)]
        for i in ids:
            assert self.refcount[i] == 0, f"block {i} on free list with refs"
            self.refcount[i] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        for i in ids:
            assert i != GARBAGE_BLOCK and self.refcount[i] > 0, (
                f"incref of dead block {i}")
            self.refcount[i] += 1

    def free(self, ids: Sequence[int]) -> List[int]:
        """Drop one reference per id; blocks whose refcount hits zero go
        back to the free pool (gen bumped).  Returns the released ids."""
        released = []
        for i in ids:
            assert i != GARBAGE_BLOCK, "freeing the garbage block"
            assert self.refcount[i] > 0, f"double free of block {i}"
            self.refcount[i] -= 1
            if self.refcount[i] == 0:
                self.gen[i] += 1
                self.free_list.append(i)
                released.append(i)
        self._check()
        return released

    def _check(self) -> None:
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "free-list duplicate"
        for i in range(1, self.n_blocks):
            if i in free:
                assert self.refcount[i] == 0, f"block {i} free with refs"
            else:
                assert self.refcount[i] > 0, f"block {i} leaked (0 refs, " \
                    "not free)"

    # alias so callers can run the invariant sweep explicitly (tests)
    check = _check


class PagedCachePool:
    """Block-paged decode cache: attention K/V over physical token blocks,
    presents the same stacked ``(G, B, ...)`` leaf layout to the engine's
    admission writes.

    ``max_tokens`` (the engine's ``max_cache_tokens``) is the exact total
    K/V token budget: ``max_tokens // block_size`` allocatable blocks
    shared by ALL in-flight requests, instead of the contiguous pool's
    per-slot rows.  Without it the pool matches the contiguous capacity
    (``n_slots`` full logical rows)."""

    def __init__(self, cfg, n_slots: int, cache_len: int, *,
                 block_size: int = 16, max_tokens: Optional[int] = None,
                 device):
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.block_size = bs = block_size
        window = cfg.sliding_window
        # true logical length (the decode ring modulus); storage pads up to
        # whole blocks, reads mask `slot < attn_len` so the pad is inert
        self.attn_len = min(cache_len, window) if window else cache_len
        self.blocks_per_slot = nb = max(1, -(-self.attn_len // bs))
        structs = M.init_cache(cfg, n_slots, cache_len, device="meta")
        self.has_attn = any("k" in grp for grp in structs.values())
        if max_tokens is not None:
            n_alloc = max(1, max_tokens // bs)
        else:
            n_alloc = n_slots * nb
        self.n_blocks = n_alloc + 1          # +1: the garbage block
        self.allocator = BlockAllocator(self.n_blocks, bs)
        # shared-prefix reuse needs token-determined K/V: absolute positions
        # only (no ring wraparound) and no per-request side inputs (an
        # encoder-decoder's self-attention K/V depend on the request's
        # frames through the cross blocks below them; a vision config's
        # text rows on the image rows before them)
        self.share_prefixes = (not window and not cfg.enc_dec
                               and cfg.frontend != "vision")
        self._prefix: "OrderedDict[Tuple[int, ...], Tuple[Tuple[int, ...], Tuple[int, ...]]]" = OrderedDict()  # noqa: E501
        self.prefix_hits = 0                 # shared blocks reused (total)
        self.prefix_lookups = 0
        self.cache = self._init_cache(structs, device)

    def _init_cache(self, structs, device) -> Dict[str, Dict[str, Any]]:
        bs, npb = self.block_size, self.n_blocks
        cache: Dict[str, Dict[str, Any]] = {}
        for sk, grp in structs.items():
            c = {}
            for name, sd in grp.items():
                if name in PAGED_LEAVES:
                    g, _, _, kvh, hd = sd.shape
                    c[name] = torch.zeros((g, npb, bs, kvh, hd),
                                          dtype=sd.dtype, device=device)
                else:                 # sLSTM's "m" starts at -1e9
                    c[name] = torch.full(sd.shape, M.CACHE_FILL.get(name, 0.0),
                                         dtype=sd.dtype, device=device)
            cache[sk] = c
        return cache

    @property
    def nbytes(self) -> int:
        return tree_bytes(self.cache)

    def blocks_for_span(self, span: int) -> int:
        """Blocks one request of ``span`` total tokens pins.  Windowed
        caches ring over the full per-slot block set regardless of span."""
        if not self.has_attn:
            return 0
        if self.cfg.sliding_window:
            return self.blocks_per_slot
        return min(self.blocks_per_slot, -(-span // self.block_size))

    def allocate(self, prompt_tokens: Sequence[int],
                 span: int) -> Optional[PagedAlloc]:
        """Blocks for one admission (None = not enough free blocks).

        Leading fully-filled prompt blocks are looked up in the shared-
        prefix registry; on a hit they are increfed instead of allocated
        (the engine then routes their prefill writes to the garbage
        block).  Only blocks strictly inside the prompt are shareable —
        decode writes land at pos >= prompt_len, past every shared block."""
        need = self.blocks_for_span(span)
        if need == 0:
            return PagedAlloc(ids=(), n_shared=0)
        bs = self.block_size
        tokens = tuple(int(t) for t in prompt_tokens)
        shareable = min(len(tokens) // bs, need) if self.share_prefixes \
            else 0
        shared: List[int] = []
        if shareable:
            self.prefix_lookups += 1
            for k in range(shareable, 0, -1):
                ent = self._prefix.get(tokens[:k * bs])
                if ent is None:
                    continue
                ids, gens = ent
                if all(self.allocator.refcount[i] > 0
                       and self.allocator.gen[i] == g
                       for i, g in zip(ids, gens)):
                    shared = list(ids)
                    break
                del self._prefix[tokens[:k * bs]]    # stale: owner retired
        fresh = self.allocator.alloc(need - len(shared))
        if fresh is None:
            return None
        self.allocator.incref(shared)
        ids = shared + fresh
        self.prefix_hits += len(shared)
        for k in range(len(shared) + 1, shareable + 1):
            key = tokens[:k * bs]
            self._prefix[key] = (tuple(ids[:k]),
                                 tuple(self.allocator.gen[i]
                                       for i in ids[:k]))
            self._prefix.move_to_end(key)
            while len(self._prefix) > PREFIX_REGISTRY_CAP:
                self._prefix.popitem(last=False)
        return PagedAlloc(ids=tuple(ids), n_shared=len(shared))

    def release(self, ids: Sequence[int]) -> None:
        """Retire one owner: decref every block; last owner frees them
        (the registry detects recycled blocks via the bumped gen)."""
        self.allocator.free(ids)

    def table_row(self, alloc: PagedAlloc) -> List[int]:
        """(nb,) physical ids for the decode block table, garbage-padded."""
        row = list(alloc.ids)
        return row + [GARBAGE_BLOCK] * (self.blocks_per_slot - len(row))

    def write_row(self, alloc: PagedAlloc) -> List[int]:
        """(nb,) physical ids for the admission scatter: shared-prefix
        blocks are redirected to the garbage block (already filled by the
        first writer — rewriting them would race ulp-level duplicates)."""
        row = [GARBAGE_BLOCK] * alloc.n_shared + list(
            alloc.ids[alloc.n_shared:])
        return row + [GARBAGE_BLOCK] * (self.blocks_per_slot - len(row))
