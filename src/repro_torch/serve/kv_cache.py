"""Paged KV-cache pool for batched decode (counterpart of
``repro/serve/kv_cache.py``, DESIGN.md §15).

* one page pool per cache side (K and V) on the model's device,
  page-major: ``(num_pages, layers, kv_heads, page_size, head_dim)``; a
  page holds ``page_size`` consecutive cache positions of one slot across
  every layer;
* a per-slot page table (position-ordered page ids) plus the slot's valid
  length; pages are allocated as the cache grows and return to the free
  list when the slot is recycled;
* ``gather`` packs a *shape bucket* (slots of equal KV length, found by
  ``shape_buckets``) into one batched cache ``{"layers": {"k": (L, B,
  Hkv, W, hd), "v": ...}, "len": int}`` that ``decode_step`` advances in
  one call; ``scatter`` writes the updated buffers back through the page
  tables with one indexed write per pool.

Gather→compute→scatter round-trips are value-exact (pages are plain
slices).  Unlike the JAX pool, which returns new arrays, the port's pools
are updated in place.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core import runtime


def shape_buckets(kv_lens: Sequence[int]
                  ) -> List[Tuple[int, Tuple[int, ...]]]:
    """Group slot positions by KV length, order-preserving.

    Returns ``[(kv_len, positions), ...]`` where ``positions`` index into
    ``kv_lens``; buckets appear in order of their first member, members
    keep their relative order."""
    order: List[int] = []
    members: Dict[int, List[int]] = {}
    for i, kv in enumerate(kv_lens):
        kv = int(kv)
        if kv < 1:
            raise ValueError(f"kv_lens must be >= 1, got {kv_lens!r}")
        if kv not in members:
            members[kv] = []
            order.append(kv)
        members[kv].append(i)
    return [(kv, tuple(members[kv])) for kv in order]


@dataclasses.dataclass
class _SlotEntry:
    pages: List[int]          # position-ordered page ids
    length: int               # valid cache entries (== cache["len"])


class PagedKVCache:
    """Demand-paged K/V pool for one engine's decode slots.  It pages only
    the plain per-layer ``{"k", "v"}`` cache tree of the dense
    transformer."""

    def __init__(self, *, slots: int, num_layers: int, kv_heads: int,
                 width: int, head_dim: int, dtype: torch.dtype,
                 page_size: int = 64, device=None) -> None:
        """``device`` defaults to the card and raises without one."""
        if slots < 1 or width < 1:
            raise ValueError(f"slots ({slots}) and width ({width}) must "
                             "be >= 1")
        device = runtime.resolve_device(device)
        self.slots = slots
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.width = width                     # per-slot cache positions
        self.head_dim = head_dim
        self.page_size = min(int(page_size), width)
        self.pages_per_slot = -(-width // self.page_size)
        self.num_pages = slots * self.pages_per_slot
        shape = (self.num_pages, num_layers, kv_heads, self.page_size,
                 head_dim)
        self._k_pool = torch.zeros(shape, dtype=dtype, device=device)
        self._v_pool = torch.zeros(shape, dtype=dtype, device=device)
        self._free: deque = deque(range(self.num_pages))
        self._table: Dict[int, _SlotEntry] = {}

    # ------------------------------------------------------------------
    # Construction / introspection
    # ------------------------------------------------------------------

    @staticmethod
    def supports(cache) -> bool:
        """True iff ``cache`` is the plain stacked-KV tree this pool pages
        (``{"layers": {"k", "v"}, "len"}`` with B == 1 leaves)."""
        if not isinstance(cache, dict):
            return False
        layers = cache.get("layers")
        if not isinstance(layers, dict) or set(layers) != {"k", "v"}:
            return False
        k = layers["k"]
        return isinstance(k, torch.Tensor) and k.dim() == 5 \
            and k.shape[1] == 1

    @classmethod
    def from_cache(cls, cache, *, slots: int,
                   page_size: int = 64) -> "PagedKVCache":
        """Size a pool from one admitted B=1 cache's leaf shapes."""
        k = cache["layers"]["k"]               # (L, 1, Hkv, W, hd)
        L, _, Hkv, W, hd = k.shape
        return cls(slots=slots, num_layers=L, kv_heads=Hkv, width=W,
                   head_dim=hd, dtype=k.dtype, page_size=page_size,
                   device=k.device)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def len_of(self, slot: int) -> int:
        return self._table[slot].length

    def page_table(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._table[slot].pages)

    def _occupied(self, length: int) -> int:
        """Cache positions holding live entries at ``length`` (a wrapped
        ring buffer caps at the full width)."""
        return min(length, self.width)

    def _pages_for(self, length: int) -> int:
        return -(-self._occupied(length) // self.page_size) if length else 0

    def _alloc(self, entry: _SlotEntry, length: int) -> None:
        need = self._pages_for(length)
        while len(entry.pages) < need:
            if not self._free:
                raise RuntimeError("paged KV pool exhausted (page leak?)")
            entry.pages.append(self._free.popleft())

    def _ids(self, entries: Sequence[_SlotEntry], npg: int) -> torch.Tensor:
        return torch.tensor([e.pages[:npg] for e in entries],
                            dtype=torch.long,
                            device=self._k_pool.device).reshape(-1)

    # ------------------------------------------------------------------
    # Slot lifecycle
    # ------------------------------------------------------------------

    def admit(self, slot: int, cache) -> None:
        """Page in one freshly prefilled B=1 cache for ``slot``."""
        if slot in self._table:
            raise ValueError(f"slot {slot} already admitted")
        if not self.supports(cache):
            raise ValueError("cache tree is not the plain {'k','v'} "
                             "layout this pool pages")
        entry = _SlotEntry(pages=[], length=int(cache["len"]))
        self._alloc(entry, entry.length)
        self._table[slot] = entry
        if entry.pages:
            self._write(entry, cache["layers"]["k"][:, 0],
                        cache["layers"]["v"][:, 0])

    def free(self, slot: int) -> None:
        """Recycle a finished slot's pages back to the pool."""
        entry = self._table.pop(slot)
        self._free.extend(entry.pages)

    # ------------------------------------------------------------------
    # Bucket gather / scatter
    # ------------------------------------------------------------------

    def gather(self, slot_ids: Sequence[int]):
        """Pack one shape bucket (slots of equal length) into a batched
        decode cache ``{"layers": {"k": (L, B, Hkv, W, hd), "v": ...},
        "len": int}``; positions past the slots' pages are zero."""
        entries = [self._table[s] for s in slot_ids]
        lens = {e.length for e in entries}
        if len(lens) != 1:
            raise ValueError(f"bucket slots {list(slot_ids)} hold unequal "
                             f"lengths {sorted(lens)}")
        length = entries[0].length
        B = len(entries)
        shape = (self.num_layers, B, self.kv_heads, self.width,
                 self.head_dim)
        out = {"k": torch.zeros(shape, dtype=self._k_pool.dtype,
                                device=self._k_pool.device),
               "v": torch.zeros(shape, dtype=self._v_pool.dtype,
                                device=self._v_pool.device)}
        npg = self._pages_for(length)
        if npg:
            ids = self._ids(entries, npg)
            S = min(npg * self.page_size, self.width)
            for side, pool in (("k", self._k_pool), ("v", self._v_pool)):
                pages = pool.index_select(0, ids).view(
                    B, npg, self.num_layers, self.kv_heads, self.page_size,
                    self.head_dim)
                dense = pages.permute(2, 0, 3, 1, 4, 5).reshape(
                    self.num_layers, B, self.kv_heads,
                    npg * self.page_size, self.head_dim)
                out[side][:, :, :, :S] = dense[:, :, :, :S]
        return {"layers": out, "len": length}

    def scatter(self, slot_ids: Sequence[int], cache) -> None:
        """Write one advanced bucket cache back through the page tables,
        allocating the page each slot's growth step crossed into; one
        indexed write per pool for the whole bucket."""
        new_len = int(cache["len"])
        entries = [self._table[s] for s in slot_ids]
        for e in entries:
            if new_len < e.length:
                raise ValueError("scatter would shrink a slot's cache")
            self._alloc(e, new_len)
            e.length = new_len
        npg = self._pages_for(new_len)
        if npg == 0:
            return
        B = len(entries)
        ids = self._ids(entries, npg)
        for side, pool in (("k", self._k_pool), ("v", self._v_pool)):
            pool.index_copy_(0, ids, self._unpack(cache["layers"][side],
                                                  B, npg))

    def _unpack(self, dense: torch.Tensor, B: int, npg: int) -> torch.Tensor:
        """(L, B, Hkv, W, hd) -> (B * npg, L, Hkv, pg, hd) pages."""
        S = npg * self.page_size
        if S > self.width:
            dense = torch.nn.functional.pad(dense, (0, 0, 0, S - self.width))
        pages = dense[:, :, :, :S].reshape(
            self.num_layers, B, self.kv_heads, npg, self.page_size,
            self.head_dim)
        return pages.permute(1, 3, 0, 2, 4, 5).reshape(
            B * npg, self.num_layers, self.kv_heads, self.page_size,
            self.head_dim)

    def _write(self, entry: _SlotEntry, k: torch.Tensor,
               v: torch.Tensor) -> None:
        """Page out one slot's dense (L, Hkv, W, hd) buffers."""
        npg = len(entry.pages)
        ids = self._ids([entry], npg)
        for pool, dense in ((self._k_pool, k), (self._v_pool, v)):
            pool.index_copy_(0, ids, self._unpack(dense[:, None], 1, npg))
