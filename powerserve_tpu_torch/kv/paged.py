"""Paged int8 KV pool: memory oversubscription across batch slots.

The dense KVCache reserves max_seq positions for every slot. Here K/V
live in a shared pool of fixed-size pages ([L, P, Hkv, page, D]) and
each slot maps its logical positions onto pool pages through a page
table, so the cache holds P * page tokens however many slots there are
and however long one of them may grow (vLLM-style paging).

  k/v        [L, P, Hkv, page, D] int8 pool slabs
  k_scale/
  v_scale    [L, P, Hkv, page] f32 per-(token, head) scales
  page_table [S, max_pages] int32 — pool page id, or P = unallocated
  mask       [S, T_logical] bool (T_logical = max_pages * page)
  pos        [S] int32

Writes translate logical positions to (page, row) and drop positions
outside [0, T_logical) or on an unallocated page, as JAX's scatter
mode="drop" drops them: locate() names page P for such a lane, and the
write sends it to the spare row past the end of the pool's storage (the
dense cache's, kv/cache.py), which no page table entry names. Every lane
is written with a fixed shape, so nothing is read to the host.
The mask and pos ops are the dense cache's: they never touch K/V. The
page table is pushed from the host allocator `PagePool`, which the
scheduler drives between device steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.flash_decode import gather_pages
from .cache import KVCache, new_storage


class PagedKVCache(KVCache):
    def __init__(self, storage: list[torch.Tensor], shape: tuple,
                 page_table: torch.Tensor, mask: torch.Tensor,
                 pos: torch.Tensor, page_size: int):
        """storage and shape [L, P, Hkv, page, D] as the dense cache's."""
        super().__init__(storage, shape, mask, pos)
        self.page_table = page_table
        self.page_size = page_size

    @classmethod
    def create(cls, n_layers: int, n_slots: int, max_seq: int,
               n_kv_heads: int, head_dim: int,
               device: str | torch.device | None = None, *, n_pages: int,
               page_size: int = 64) -> "PagedKVCache":
        """max_seq: per-slot logical capacity (rounded up to whole pages);
        n_pages: pool capacity — oversubscribed when n_pages * page_size
        < n_slots * max_seq."""
        dev = resolve_device(device)
        max_pages = -(-max_seq // page_size)
        shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
        return cls(new_storage(shape, dev), shape,
                   torch.full((n_slots, max_pages), n_pages,
                              dtype=torch.int32, device=dev),
                   torch.zeros(n_slots, max_pages * page_size,
                               dtype=torch.bool, device=dev),
                   torch.zeros(n_slots, dtype=torch.int32, device=dev),
                   page_size)

    def clone(self) -> "PagedKVCache":
        """An independent copy: storages, page table, mask and pos."""
        return PagedKVCache([f.clone() for f in self.storage],
                            tuple(self.k.shape), self.page_table.clone(),
                            self.mask.clone(), self.pos.clone(),
                            self.page_size)

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def n_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        """Logical per-slot capacity."""
        return self.max_pages * self.page_size

    def locate(self, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """[S, ...] logical positions -> (pool pages, rows in the page).
        Out-of-range positions and unallocated pages give page P."""
        P = self.n_pages
        ok = (positions >= 0) & (positions < self.max_seq)
        pidx = torch.where(ok, positions // self.page_size, 0).long()
        rows = torch.arange(self.n_slots, device=positions.device)
        rows = rows.reshape((-1,) + (1,) * (positions.dim() - 1))
        pages = self.page_table[rows, pidx]
        pages = torch.where(ok & (pages < P), pages, P)
        offs = torch.where(ok, positions % self.page_size, 0)
        return pages, offs

    def write_index(self, positions: torch.Tensor) -> torch.Tensor:
        """Storage rows [L, S, Tq, Hkv] that the entries of positions
        [S, Tq] write for every layer and head: the pool row of an
        allocated page, else the spare row. Its shape depends on
        positions.shape only, and nothing is read to the host."""
        pages, offs = self.locate(positions)
        return self._storage_rows(pages < self.n_pages, pages.long(),
                                  offs.long())

    def commit(self, blocks: list[tuple], index: torch.Tensor) -> None:
        """Store every layer's quantized new K/V at `index` (from
        write_index), one indexed write per pool tensor: blocks[l] =
        (kq [S, Tq, Hkv, D] int8, ks [S, Tq, Hkv] f32, vq, vs) of layer
        l, as the deferred forward quantized them. The pool then holds
        what a write of each layer before its attention would have put
        there."""
        for j, flat in enumerate(self.storage):
            flat[index] = torch.stack([b[j] for b in blocks])

    def _gather_rows(self, src_positions: torch.Tensor, dst: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The dense cache's, in pool coordinates: a source on no page
        reads the pool's last page (as the JAX pool clips it); a lane
        whose source is out of range, or whose destination is out of
        range or unallocated, is dropped."""
        src_ok = (src_positions >= 0) & (src_positions < self.max_seq)
        sp, so = self.locate(src_positions)
        dp, do = self.locate(torch.where(src_ok, dst, -1))
        src = self._storage_rows(torch.ones_like(src_ok),
                                 sp.clamp(max=self.n_pages - 1).long(),
                                 so.long())
        return src, self._storage_rows(dp < self.n_pages, dp.long(),
                                       do.long())

    def gather_slab(self, slab: torch.Tensor) -> torch.Tensor:
        """One layer's pool slab [P, Hkv, page(, D)] -> the per-slot view
        [S, Hkv, T_logical(, D)] in the dense cache's layout
        (unallocated pages read a clipped pool page; hidden by the mask)."""
        return gather_pages(slab, self.page_table)

    def save_slot_prefix(self, slot: int, n: int) -> dict:
        """The first n tokens of one slot as dense copies, in the dense
        cache's snapshot format (so prefix-cache entries interoperate)."""
        n_pg = -(-n // self.page_size)
        pt = self.page_table[slot, :n_pg].long().clamp(max=self.n_pages - 1)

        def dense(pool):  # [L, P, H, page(, D)] -> [L, H, n(, D)]
            g = pool[:, pt].movedim(2, 1)  # [L, H, n_pg, page(, D)]
            g = g.reshape((pool.shape[0], pool.shape[2],
                           n_pg * self.page_size) + tuple(pool.shape[4:]))
            return g[:, :, :n].clone()

        return {"n": n, "k": dense(self.k), "v": dense(self.v),
                "k_scale": dense(self.k_scale),
                "v_scale": dense(self.v_scale)}

    def restore_slot_prefix(self, slot: int, saved: dict) -> None:
        """Write a dense snapshot into this slot's (allocated) pages;
        mask/pos cover exactly the prefix."""
        n = saved["n"]
        positions = torch.full((self.n_slots, n), -1, dtype=torch.int64,
                               device=self.device)
        positions[slot] = torch.arange(n, device=self.device)
        rows = self.write_index(positions)[:, slot]  # [L, n, H]
        for flat, name in zip(self.storage, ("k", "k_scale", "v", "v_scale")):
            flat[rows] = saved[name].movedim(2, 1)  # [L, n, H(, D)]
        self.mask[slot] = torch.arange(self.max_seq, device=self.device) < n
        self.pos[slot] = n

    def assign_pages(self, table: np.ndarray) -> None:
        """Replace the whole page table ([S, max_pages], P = unallocated).
        On the card the copy leaves from pinned memory without a wait, in
        stream order: a tick still in flight reads the table it was
        dispatched with."""
        t = torch.from_numpy(np.array(table, np.int32))
        if self.page_table.is_cuda:
            t = t.pin_memory()
        self.page_table.copy_(t, non_blocking=True)


class PagePool:
    """Host-side page allocator: free lists and per-slot ownership.

    The scheduler calls ensure()/release() between device steps and
    pushes `table` (the numpy mirror) with flush() when it changed. No
    device state lives here.

    n_groups > 1 partitions the pool for data-parallel serving: the slots
    of dp block g (a contiguous range) take pages only from partition
    [g * P / n_groups, (g + 1) * P / n_groups), the pages that block's
    ranks hold (parallel/tp.py). Page ids in the table stay global."""

    def __init__(self, n_pages: int, n_slots: int, max_pages: int,
                 page_size: int, n_groups: int = 1):
        if n_pages % n_groups or n_slots % n_groups:
            raise ValueError(f"pages ({n_pages}) and slots ({n_slots}) must "
                             f"divide into {n_groups} dp groups")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.n_groups = n_groups
        self.group_pages = n_pages // n_groups
        self._slots_per_group = n_slots // n_groups
        self._free: list[list[int]] = [
            list(range(g * self.group_pages, (g + 1) * self.group_pages))
            for g in range(n_groups)]
        self.owned: list[list[int]] = [[] for _ in range(n_slots)]
        self.table = np.full((n_slots, max_pages), n_pages, np.int32)
        self.dirty = False

    def group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free)

    def n_free_for(self, slot: int) -> int:
        """Free pages `slot` may take (its group's partition)."""
        return len(self._free[self.group_of(slot)])

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow `slot`'s mapping to cover n_tokens logical positions.
        False (allocating nothing further) when the slot's partition or
        its logical range runs out: the caller preempts or defers."""
        need = -(-n_tokens // self.page_size)
        if need > self.max_pages:
            return False
        free = self._free[self.group_of(slot)]
        cur = len(self.owned[slot])
        while cur < need:
            if not free:
                return False
            pg = free.pop()
            self.table[slot, cur] = pg
            self.owned[slot].append(pg)
            cur += 1
            self.dirty = True
        return True

    def release(self, slot: int) -> None:
        """Return all of a slot's pages to its group's partition."""
        if self.owned[slot]:
            self._free[self.group_of(slot)].extend(self.owned[slot])
            self.owned[slot] = []
            self.table[slot, :] = self.n_pages
            self.dirty = True

    def flush(self, kv: PagedKVCache) -> None:
        """Push the mirror to the device page table if it changed."""
        if self.dirty:
            kv.assign_pages(self.table)
            self.dirty = False
