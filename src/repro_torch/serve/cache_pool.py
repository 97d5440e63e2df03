"""Cache pools for the serving engine: contiguous per-slot lanes and the
paged block-KV pool.

``CachePool`` preallocates ``num_slots`` full-length lanes: ring leaves
``(L, num_slots, ring, ...)`` (an alternating config's two trees, local and
global rings, alike), an xLSTM model's recurrent states ``(nG, nM,
num_slots, ...)`` and ``(nG, num_slots, ...)``, or a Zamba2 model's
``{"mamba": {ssm_state, conv_buf} (nG, nM, num_slots, ...), "attn": rings
(nG, num_slots, ring, ...)}``; a request is placed by copying its batch-1
prefill cache into lane ``slot``, each leaf at its own batch axis
(``cache_batch_axes``).  A recurrent state is rewritten for every lane at
every step, so the serve step keeps an inactive lane's state with
``freeze_inactive``; an attention ring guards its own writes.

``PagedCachePool`` holds ONE shared block pool per leaf, ``(L, n_blocks,
block_size, ...)``, plus a host-side block table ``(num_slots,
blocks_per_slot)`` mapping each lane's logical ring blocks to physical
blocks.  A lane holds only the blocks its tokens occupy.  Blocks are
granted on demand as decode crosses a block boundary and released at
retirement; a freshly granted block gets its ``kv_pos`` invalidated
(``reset_blocks``) so a previous owner's positions never pass the mask.

Copy-on-write prefix sharing: blocks are refcounted and a prefix-hash index
(``match_prefix`` / ``register_prefix``) maps block-aligned prompt prefixes
— and whole prompts, with the last-token logits row — to live block
chains.  A lane whose prompt matches maps the chain's blocks read-only
(``share_map``); the first write into a block with refcount > 1 copies it
first (``cow``: fresh block, one ``ops.block_copy_leaves`` of every
leaf, remap, decref).  Chains never pin blocks: a block's death drops every chain that
cites it.  Sharing is safe because every prompt starts at position 0,
decode writes precede reads at the same position, and stale future slots
of a shared tail block are excluded by the causal / ring-validity mask.

Host swap tier: ``gather_lane`` snapshots a lane's logical ring as the
leaves of a batch-1 prefill cache, ``(L, 1, ring_len, ...)``, so that
``insert`` takes the snapshot back unchanged on swap-in, into whatever
slot and blocks the lane is granted then.

The pools update their tensors in place.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.models.layers.attention import init_attn_cache
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import dtype_of, ring_length

# The families whose every layer has one ring geometry (the reference's).
PAGED_FAMILIES = ("dense", "moe")


def cache_batch_axes(api, cfg):
    """Each cache leaf's batch axis, as a tree like the cache: the one axis
    that differs between ``init_cache`` at batch 1 and 2 (of 8 positions),
    made on the ``meta`` device (shapes only, no memory)."""
    a1 = api.init_cache(cfg, 1, 8, device="meta")
    a2 = api.init_cache(cfg, 2, 8, device="meta")

    def axis_of(x, y):
        diff = [i for i, (d1, d2) in enumerate(zip(x.shape, y.shape))
                if d1 != d2]
        if len(diff) != 1:
            raise ValueError(f"cannot locate batch axis: {tuple(x.shape)} vs "
                             f"{tuple(y.shape)}")
        return diff[0]

    return tree_util.map_(axis_of, a1, a2)


def _expand(mask, axis: int, ndim: int):
    """(B,) bool -> broadcastable to an ``ndim`` leaf with B at ``axis``."""
    return mask.reshape((1,) * axis + (-1,) + (1,) * (ndim - axis - 1))


def freeze_inactive(old_cache, new_cache, active, axes):
    """Write ``new_cache`` into ``old_cache`` in place, leaf by leaf at its
    batch axis, for the active lanes only (every lane with ``active``
    None): a retired or empty lane's recurrent state never drifts while
    others decode.  A leaf the decode returned as it was given (a hybrid
    model's attention ring, written in place and guarded by the ring
    itself) is left alone.  Returns ``old_cache``."""
    def put(o, n, ax):
        if n is o:
            return
        o.copy_(n if active is None else
                torch.where(_expand(active, ax, n.ndim), n, o))
    tree_util.map_(put, old_cache, new_cache, axes)
    return old_cache


class _LanePool:
    """Lane (slot) free-list shared by both pool layouts."""

    def __init__(self, num_slots: int, cache_len: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.cache_len = cache_len
        self._free: List[int] = list(range(num_slots - 1, -1, -1))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        return self._free.pop()

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)


class CachePool(_LanePool):
    """``num_slots`` lanes carved out of one preallocated cache."""

    def __init__(self, cfg, num_slots: int, cache_len: int, *,
                 force_window: int = 0, device="cuda"):
        super().__init__(num_slots, cache_len)
        api = get_model(cfg)
        self.cache = api.init_cache(
            cfg, num_slots, cache_len, force_window=force_window,
            dtype=dtype_of(cfg.compute_dtype), device=device)
        self.batch_axes = cache_batch_axes(api, cfg)

    @property
    def pool_blocks(self) -> int:
        """Lane granularity: one lane == one block."""
        return self.num_slots

    @property
    def blocks_in_use(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def fragmentation(self) -> float:
        return 0.0

    def insert(self, req_cache, slot: int) -> None:
        """Copy a batch-1 prefill cache (a tree like the pool's, batch 1)
        into lane ``slot``, each leaf at its batch axis."""
        def put(leaf, req, ax):
            leaf.select(ax, slot).copy_(req.select(ax, 0))
        tree_util.map_(put, self.cache, req_cache, self.batch_axes)


# ---------------------------------------------------------------------------
# Paged block pool
# ---------------------------------------------------------------------------

class PoolExhausted(RuntimeError):
    """Too few free blocks for a grant.  The engine parks, evicts or
    requeues on this error alone; every other error (a kernel that fails to
    build or launch, a CUDA error) propagates."""


class BlockAllocator:
    """LIFO free-list allocator over ``n_blocks`` physical blocks, with
    per-block refcounts for copy-on-write prefix sharing.

    Invariant: the free list and the allocated set partition
    ``range(n_blocks)``, and a block's refcount equals the number of
    lane-table entries citing it."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._used: set = set()
        self._ref: dict = {}                   # block -> refcount (>= 1)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    @property
    def fragmentation(self) -> float:
        """Free-list shredding in [0, 1]: ``(runs - 1) / (free - 1)`` over
        maximal runs of consecutive free block ids."""
        free = len(self._free)
        if free <= 1:
            return 0.0
        ids = sorted(self._free)
        runs = 1 + sum(1 for a, b in zip(ids, ids[1:]) if b != a + 1)
        return (runs - 1) / (free - 1)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` blocks at refcount 1; raises PoolExhausted (allocating
        nothing) when fewer are free — the caller parks or evicts."""
        if n > len(self._free):
            raise PoolExhausted(
                f"block pool exhausted: want {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> int:
        if block not in self._used:
            raise ValueError(f"cannot share free block {block}")
        self._ref[block] += 1
        return self._ref[block]

    def decref(self, block: int) -> bool:
        """Drop one reference; True when the block went back to the free
        list (last reference)."""
        if block not in self._used:
            raise ValueError(f"block {block} double-freed (or never "
                             f"allocated)")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return False
        del self._ref[block]
        self._used.discard(block)
        self._free.append(block)
        return True


def auto_block_size(ring_len: int, target: int = 16, *,
                    min_block: int = 8) -> int:
    """Divisor of ``ring_len`` nearest ``target`` (ties -> the larger),
    never below ``min(min_block, ring_len)``.  Divisibility keeps the
    logical view of a lane exactly its ring."""
    floor = min(min_block, ring_len)
    divs = [d for d in range(1, ring_len + 1)
            if ring_len % d == 0 and d >= floor]
    return min(divs, key=lambda d: (abs(d - target), -d))


class PagedCachePool(_LanePool):
    """Paged block-KV pool: one shared block pool + per-lane block tables.

    Geometry: the logical per-request ring is ``ring_len`` slots (the
    window when one applies, else ``cache_len``), carved into
    ``blocks_per_slot`` blocks of ``block_size``.  The pool holds
    ``pool_blocks`` physical blocks (default: ``num_slots *
    blocks_per_slot``; fewer oversubscribes lanes against real footprints).
    """

    def __init__(self, cfg, num_slots: int, cache_len: int, *,
                 block_size: int = 0, pool_blocks: int = 0,
                 force_window: int = 0, device="cuda"):
        super().__init__(num_slots, cache_len)
        if cfg.family not in PAGED_FAMILIES or cfg.local_global_alternating:
            raise ValueError(
                f"paged KV pools need one uniform ring geometry per layer "
                f"(families {PAGED_FAMILIES}, no local/global alternation); "
                f"got {cfg.family!r}")
        ring_len = ring_length(cfg, cache_len, force_window=force_window)
        block_size = block_size or auto_block_size(ring_len)
        if ring_len % block_size:
            raise ValueError(f"block_size {block_size} must divide the ring "
                             f"length {ring_len}")
        self.ring_len = ring_len
        self.block_size = block_size
        self.blocks_per_slot = ring_len // block_size
        n_blocks = pool_blocks or num_slots * self.blocks_per_slot
        self.device = torch.device(device)
        self.cache = init_attn_cache(
            n_blocks, block_size, cfg.num_kv_heads, cfg.resolved_head_dim(),
            layers=cfg.num_layers, dtype=dtype_of(cfg.compute_dtype),
            device=device)
        self.allocator = BlockAllocator(n_blocks)
        self.table = np.full((num_slots, self.blocks_per_slot), -1, np.int32)
        # prefix-hash index: key -> {"blocks": tuple, "logits": row | None}.
        # b"P" + block-aligned prefix bytes shares KV (still prefills);
        # b"F" + whole-prompt bytes skips prefill (the stored last-token
        # logits row seeds the first sample).
        self._chains: dict = {}
        self._block_chains: dict = {}          # block -> set of chain keys

    # -- accounting ---------------------------------------------------------

    @property
    def pool_blocks(self) -> int:
        return self.allocator.n_blocks

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.used_blocks

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def fragmentation(self) -> float:
        return self.allocator.fragmentation

    def blocks_for(self, extent: int) -> int:
        """Blocks covering ring slots [0, extent)."""
        return -(-min(extent, self.ring_len) // self.block_size)

    def lane_blocks(self, slot: int) -> int:
        """Physical blocks lane ``slot``'s table row maps, shared ones
        included (the bytes a swap-out accounts)."""
        return int((self.table[slot] >= 0).sum())

    @property
    def block_bytes(self) -> int:
        """Device bytes of one physical block across every leaf and layer."""
        return sum(leaf.numel() * leaf.element_size() // leaf.shape[1]
                   for leaf in self.cache.values())

    def refcount(self, block: int) -> int:
        return self.allocator.refcount(block)

    def release(self, slot: int) -> None:
        """Retire a lane: one decref per block in its table row; blocks
        whose last reference this was go back to the free list and their
        prefix chains die with them."""
        super().release(slot)
        row = self.table[slot]
        for b in row[row >= 0]:
            if self.allocator.decref(int(b)):
                self._drop_chains_of(int(b))
        self.table[slot] = -1

    # -- block lifecycle -----------------------------------------------------

    def grant(self, slot: int, logical_block: int) -> int:
        """Decode-time grant of one block; PoolExhausted when exhausted."""
        if self.table[slot, logical_block] >= 0:
            raise ValueError(f"slot {slot} logical block {logical_block} "
                             f"already granted")
        b = self.allocator.alloc(1)[0]
        self.table[slot, logical_block] = b
        return b

    def grant_tail(self, slot: int, start: int, n: int) -> List[int]:
        """Admission (or swap-in, from 0) grant of logical blocks
        [start, start+n); PoolExhausted without side effects when the pool
        cannot cover it."""
        if n <= 0:
            return []
        ids = self.allocator.alloc(n)
        self.table[slot, start:start + n] = ids
        return ids

    def reset_blocks(self, blocks: Sequence[int]) -> None:
        """Invalidate kv_pos of freshly granted blocks on the device."""
        if not blocks:
            return
        idx = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=self.device)
        self.cache["kv_pos"][:, idx] = -1

    # -- prefix sharing / copy-on-write --------------------------------------

    @staticmethod
    def _pkey(tokens: np.ndarray) -> bytes:
        return b"P" + np.ascontiguousarray(tokens, np.int32).tobytes()

    @staticmethod
    def _fkey(tokens: np.ndarray) -> bytes:
        return b"F" + np.ascontiguousarray(tokens, np.int32).tobytes()

    def match_prefix(self, prompt):
        """Longest live block-aligned shared prefix for ``prompt``:
        ``(blocks, full_hit, logits_row)``.  Prompts longer than the ring
        never match."""
        p = np.ascontiguousarray(prompt, np.int32)
        if len(p) == 0 or len(p) > self.ring_len:
            return [], False, None
        full = self._chains.get(self._fkey(p))
        if full is not None:
            return list(full["blocks"]), True, full["logits"]
        for n in range(len(p) // self.block_size, 0, -1):
            c = self._chains.get(self._pkey(p[:n * self.block_size]))
            if c is not None:
                return list(c["blocks"]), False, None
        return [], False, None

    def share_map(self, slot: int, blocks: Sequence[int]) -> None:
        """Map a matched chain read-only into logical blocks [0, len) of
        lane ``slot`` (refcount bump, zero allocations)."""
        for b in blocks:
            self.allocator.incref(int(b))
        self.table[slot, :len(blocks)] = np.asarray(blocks, np.int32)

    def register_prefix(self, slot, prompt, logits_row=None) -> None:
        """Index this lane's freshly prefilled prompt: one chain per
        block-aligned prefix plus, with ``logits_row``, a whole-prompt
        chain.  An existing key keeps its incumbent."""
        p = np.ascontiguousarray(prompt, np.int32)
        if len(p) == 0 or len(p) > self.ring_len:
            return
        row = self.table[slot]
        keys = [(self._pkey(p[:n * self.block_size]), n)
                for n in range(1, len(p) // self.block_size + 1)]
        if logits_row is not None:
            keys.append((self._fkey(p), self.blocks_for(len(p))))
        for key, n in keys:
            if key in self._chains or np.any(row[:n] < 0):
                continue
            blocks = tuple(int(b) for b in row[:n])
            entry = {"blocks": blocks, "logits": None}
            if key[:1] == b"F":
                entry["logits"] = logits_row
            self._chains[key] = entry
            for b in blocks:
                self._block_chains.setdefault(b, set()).add(key)

    def _drop_chains_of(self, block: int) -> None:
        for key in self._block_chains.pop(block, set()):
            entry = self._chains.pop(key, None)
            if entry is None:
                continue
            for b in entry["blocks"]:
                if b != block:
                    s = self._block_chains.get(b)
                    if s is not None:
                        s.discard(key)
                        if not s:
                            del self._block_chains[b]

    def invalidate_block(self, block: int) -> None:
        """A sole owner is about to overwrite this block's prefix content
        (ring wrap): drop the chains that cite it first."""
        self._drop_chains_of(block)

    def cow(self, slot: int, logical_block: int):
        """Copy-on-write: allocate a fresh block (PoolExhausted when
        exhausted, nothing mutated), copy the tile of every leaf on the
        device, remap the table, drop the old reference.  Returns
        (old, new).  A failed copy gives the fresh block back and
        re-raises."""
        old = int(self.table[slot, logical_block])
        if old < 0:
            raise ValueError(f"slot {slot} logical block {logical_block} "
                             f"not granted")
        new = self.allocator.alloc(1)[0]
        try:
            ops.block_copy_leaves(self.cache.values(), old, new)
        except BaseException:
            self.allocator.decref(new)
            raise
        self.table[slot, logical_block] = new
        if self.allocator.decref(old):
            self._drop_chains_of(old)
        return old, new

    # -- swap tier -----------------------------------------------------------

    def gather_lane(self, slot: int) -> dict:
        """Snapshot of lane ``slot``'s logical ring: every leaf gathered
        from the lane's physical blocks into a new tensor of leaves
        ``(L, 1, ring_len, ...)``.  Ungranted logical blocks gather block 0
        with their ``kv_pos`` forced to -1, so a re-insert revalidates
        nothing stale.  The gather is queued on the device before the
        caller releases the blocks, so later writes cannot reach it."""
        row = torch.as_tensor(self.table[slot].astype(np.int64),
                              device=self.device)
        safe = row.clamp(min=0)
        T = self.blocks_per_slot
        out = {}
        for name, leaf in self.cache.items():
            y = leaf.index_select(1, safe)             # (L, T, bs, ...)
            out[name] = y.reshape((leaf.shape[0], 1, T * self.block_size)
                                  + tuple(leaf.shape[3:]))
        granted = (row >= 0)[None, :, None].expand(
            self.cache["kv_pos"].shape[0], T, self.block_size)
        kvp = out["kv_pos"].reshape(granted.shape)
        out["kv_pos"] = torch.where(granted, kvp, torch.full_like(kvp, -1)
                                    ).reshape(out["kv_pos"].shape)
        return out

    # -- data path ----------------------------------------------------------

    def insert(self, req_cache, slot: int, *, skip_blocks: int = 0) -> None:
        """Scatter a batch-1 prefill ring (leaves (L, 1, ring_len, ...))
        into this lane's granted blocks.  The first ``skip_blocks`` logical
        blocks are left alone: they are shared and already hold the same
        data."""
        row = self.table[slot]
        logical = [j for j in range(skip_blocks, self.blocks_per_slot)
                   if row[j] >= 0]
        if not logical:
            return
        dev = self.device
        phys = torch.as_tensor(row[logical].astype(np.int64), device=dev)
        src = torch.as_tensor(logical, dtype=torch.long, device=dev)
        T, bs = self.blocks_per_slot, self.block_size
        for name, leaf in self.cache.items():
            r = req_cache[name][:, 0]                  # (L, ring, ...)
            blocks = r.reshape((r.shape[0], T, bs) + tuple(r.shape[2:]))
            leaf[:, phys] = blocks[:, src].to(leaf.dtype)

    # -- invariants (tests) --------------------------------------------------

    def assert_partition(self) -> None:
        """Free list + table rows partition the pool, refcounts equal the
        number of table references, chains cite live blocks only."""
        free = set(self.allocator._free)
        held = [int(b) for b in self.table.ravel() if b >= 0]
        counts: dict = {}
        for b in held:
            counts[b] = counts.get(b, 0) + 1
        if not free.isdisjoint(held):
            raise AssertionError("block both free and granted")
        if free | set(held) != set(range(self.allocator.n_blocks)):
            raise AssertionError("block leaked (neither free nor granted)")
        if set(held) != self.allocator._used:
            raise AssertionError("allocator used-set out of sync with table")
        for b, c in counts.items():
            if self.allocator.refcount(b) != c:
                raise AssertionError(f"block {b}: refcount "
                                     f"{self.allocator.refcount(b)} != {c}")
        for key, entry in self._chains.items():
            for b in entry["blocks"]:
                if b not in self.allocator._used:
                    raise AssertionError(f"chain cites freed block {b}")
