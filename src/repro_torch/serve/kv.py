"""Block-paged KV cache: pool layout, block table, refcounted copy-on-write
prefix sharing, and the gather/scatter helpers — ported from
``repro.serve.kv``.

Each layer keeps a pool of fixed-size blocks ``(n_blocks, block_len,
n_kv_heads, head_dim)`` shared by every slot; a per-slot block table
``(n_slots, blocks_per_slot) int32`` maps a slot's logical block
(position // block_len) to a physical block. Physical block 0 is the null
block: every unallocated entry points at it, so writes past a slot's
allocation land in garbage that is never attended (the attention paths
mask it, and zero its values because 0 · NaN is NaN).

Prefix sharing: two requests whose prompts agree on a block-aligned
prefix map those logical blocks to the same physical blocks (refcount++),
read-only by construction — suffix prefill and decode only write at
positions at or past the shared length.

Unlike the reference's pure functions, :func:`scatter` writes into the
pool in place: the cache is the engine's own state, and an update in
place saves a copy of every layer's pool per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def blocks_for(n_tokens: int, block_len: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return max(0, -(-n_tokens // block_len))


@dataclass(frozen=True)
class PagedLayout:
    """Static shape of one paged pool (per layer-stack leaf)."""
    n_blocks: int          # physical blocks in the pool (incl. null block 0)
    block_len: int         # tokens per block
    blocks_per_slot: int   # block-table width = ceil(max_len / block_len)

    @property
    def view_len(self) -> int:
        """Sequence length of the gathered per-slot view."""
        return self.blocks_per_slot * self.block_len

    @staticmethod
    def plan(n_slots: int, max_len: int, block_len: int,
             n_blocks: int = 0) -> "PagedLayout":
        """Default pool: full capacity (every slot at max_len) + null block.
        Pass ``n_blocks`` to oversubscribe (fewer blocks than worst case)."""
        per_slot = blocks_for(max_len, block_len)
        return PagedLayout(n_blocks or (1 + n_slots * per_slot), block_len,
                           per_slot)


# ---------------------------------------------------------------------------
# Device side: gather / scatter
# ---------------------------------------------------------------------------

def gather_view(pool, table):
    """Contiguous per-slot view of a paged pool: pool (n_blocks, block_len,
    H, hd), table (n_slots, blocks_per_slot) → (n_slots, blocks_per_slot ·
    block_len, H, hd). Unallocated entries read the null block."""
    g = pool[table.long()]                 # (S, bps, bl, H, hd)
    return g.reshape(g.shape[0], -1, *pool.shape[2:])


def scatter(pool, table, positions, new):
    """Write per-slot tokens into their pages, in place.

    pool (n_blocks, block_len, H, hd); table (n_slots, blocks_per_slot);
    positions (n_slots, S) logical positions; new (n_slots, S, H, hd).
    Positions on unallocated entries land in the null block. Positions are
    clamped to the table width: an offset prefill's padding rows can run
    past view_len, and their garbage lands at the slot's last logical
    block, which a shared prefix never owns and decode overwrites before
    the position is first attended. Returns ``pool``."""
    bl = pool.shape[1]
    positions = positions.long().clamp(max=table.shape[1] * bl - 1)
    phys = torch.gather(table.long(), 1, positions // bl)   # (n_slots, S)
    flat_idx = (phys * bl + positions % bl).reshape(-1)
    flat = pool.view(-1, *pool.shape[2:])
    flat[flat_idx] = new.reshape(-1, *new.shape[2:]).to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# Host side: block allocation + prefix sharing
# ---------------------------------------------------------------------------

class BlockTable:
    """Host-side block table + refcounted free-list allocator over a
    shared pool. One table serves every layer. Block 0 is the null block
    and is never allocated. Fresh blocks start at refcount 1;
    :meth:`attach` bumps the count for each slot sharing a block;
    :meth:`release` decrements and frees at zero."""

    def __init__(self, layout: PagedLayout, n_slots: int):
        self.layout = layout
        self.n_slots = n_slots
        self.table = np.zeros((n_slots, layout.blocks_per_slot), np.int32)
        self._n_alloc = np.zeros(n_slots, np.int32)   # allocated per slot
        self._free: List[int] = list(range(layout.n_blocks - 1, 0, -1))
        self.refcount = np.zeros(layout.n_blocks, np.int32)
        # tuple(tokens of a whole-block-aligned prefix) → the physical
        # block holding its LAST block; chained lookups walk longer and
        # longer prefixes, so a hit set is always a chain of resident blocks
        self._prefix_to_block: Dict[Tuple[int, ...], int] = {}
        self._block_prefix: Dict[int, Tuple[int, ...]] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.layout.n_blocks - 1 - len(self._free)

    def alloc_tokens(self, slot: int) -> int:
        """KV positions resident for ``slot`` (allocated blocks × block
        length)."""
        return int(self._n_alloc[slot]) * self.layout.block_len

    def can_fit(self, n_tokens: int) -> bool:
        return blocks_for(n_tokens, self.layout.block_len) <= len(self._free)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to hold ``n_tokens`` positions; False if the pool
        is exhausted. Blocks the slot already holds are never touched."""
        need = blocks_for(n_tokens, self.layout.block_len)
        if need > self.layout.blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed "
                f"{self.layout.view_len} (blocks_per_slot × block_len)")
        have = int(self._n_alloc[slot])
        if need <= have:
            return True
        if need - have > len(self._free):
            return False
        for j in range(have, need):
            b = self._free.pop()
            self.table[slot, j] = b
            self.refcount[b] = 1
        self._n_alloc[slot] = need
        return True

    def release(self, slot: int) -> None:
        """Drop ``slot``'s reference on every block it holds; a block
        returns to the free list (and leaves the prefix map) only when its
        last reference goes."""
        n = int(self._n_alloc[slot])
        for j in range(n):
            b = int(self.table[slot, j])
            self.table[slot, j] = 0
            self.refcount[b] -= 1
            if self.refcount[b] < 0:
                raise RuntimeError(f"block {b}: refcount underflow")
            if self.refcount[b] == 0:
                key = self._block_prefix.pop(b, None)
                if key is not None:
                    self._prefix_to_block.pop(key, None)
                self._free.append(b)
        self._n_alloc[slot] = 0

    # -- prefix sharing -----------------------------------------------------
    def match_prefix(self, tokens: Sequence[int],
                     max_tokens: int | None = None) -> List[int]:
        """Longest chain of resident full blocks matching ``tokens``'
        prefix, capped at ``max_tokens``."""
        bl = self.layout.block_len
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                          max_tokens)
        chain: List[int] = []
        for j in range(limit // bl):
            b = self._prefix_to_block.get(tuple(tokens[:(j + 1) * bl]))
            if b is None:
                break
            chain.append(b)
        return chain

    def attach(self, slot: int, phys_blocks: Sequence[int]) -> int:
        """Map an empty ``slot``'s leading logical blocks onto resident
        blocks, bumping each refcount. Returns the shared token count."""
        if int(self._n_alloc[slot]) != 0:
            raise RuntimeError(f"slot {slot}: attach on a non-empty slot")
        for j, b in enumerate(phys_blocks):
            if self.refcount[b] <= 0:
                raise RuntimeError(f"block {b}: attach to a free block")
            self.table[slot, j] = b
            self.refcount[b] += 1
        self._n_alloc[slot] = len(phys_blocks)
        return len(phys_blocks) * self.layout.block_len

    def register_prefix(self, slot: int, tokens: Sequence[int],
                        max_tokens: int | None = None) -> int:
        """Publish ``slot``'s whole-block prefixes of ``tokens`` (capped at
        ``max_tokens``) for later admissions; first writer wins. Returns
        the number of blocks newly registered."""
        bl = self.layout.block_len
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                          max_tokens)
        fresh = 0
        for j in range(limit // bl):
            key = tuple(tokens[:(j + 1) * bl])
            if key in self._prefix_to_block:
                continue
            b = int(self.table[slot, j])
            if b == 0 or b in self._block_prefix:
                continue
            self._prefix_to_block[key] = b
            self._block_prefix[b] = key
            fresh += 1
        return fresh

    def rows(self, slots) -> np.ndarray:
        """Table restricted to ``slots``; other rows are nulled so a
        batched prefill cannot clobber live pages of mid-decode slots."""
        out = np.zeros_like(self.table)
        for s in slots:
            out[s] = self.table[s]
        return out

    def check(self) -> None:
        """Accounting invariants: every non-free block's refcount equals
        the number of table rows referencing it; free blocks have refcount
        0; no block is both free and referenced."""
        refs = np.zeros(self.layout.n_blocks, np.int64)
        for s in range(self.n_slots):
            for j in range(int(self._n_alloc[s])):
                refs[int(self.table[s, j])] += 1
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block in free list")
        for b in range(1, self.layout.n_blocks):
            if b in free:
                ok = self.refcount[b] == 0 and refs[b] == 0
            else:
                ok = self.refcount[b] == refs[b] > 0
            if not ok:
                raise AssertionError((b, int(self.refcount[b]), int(refs[b])))
        if self.blocks_in_use + self.free_blocks != self.layout.n_blocks - 1:
            raise AssertionError("block accounting does not add up")
