"""INT8 KV cache with mask / rollback semantics, updated in place.

Layout: k/v int8 [n_layers, n_slots, n_kv_heads, max_seq, head_dim] —
the sequence axis sits inside each head so a (slot, head) slab is
contiguous [T, D] for the attention kernel; per-(token, head) f32 scales
[L, S, Hkv, T]; mask [S, T] bool (positions visible to attention); pos
[S] int32 (stored tokens per slot, the next write index).

The JAX package updates the cache functionally; here writes go into the
same tensors, and the contents match the JAX cache entry for entry.
Positions outside [0, max_seq) — inactive slots are fed -1 — are dropped,
as JAX's scatter mode="drop" drops them, with a fixed-shape write that
reads nothing back to the host: each of k, v and the scales lives in a
flat storage one (head_dim) row longer than the public view, and every
dropped lane writes that spare row. No real lane can collide with a
dropped one (a clamped index could: indexed writes with duplicate
indices keep an arbitrary one), and no kernel, stride or snapshot sees
the spare: k, v and the scales are contiguous views of the rows before
it.

kv/paged.py's PagedKVCache keeps the same method names and signatures
(write_index/write, the mask and pos ops, the prefix snapshots), so the
model's forward and the scheduler take either cache.

SeqShardCache is a sequence-parallel rank's share of a dense cache: its
slabs hold positions [t0, t0 + T) of max_seq = sp * T, its mask those
positions, and pos stays global and the same on every rank. The same
methods take global positions: a write lands here when its position is
in this rank's slice and is dropped otherwise (the JAX forward's remap of
an sp shard's cache positions), and advance counts every in-range
position into pos. The token-tree operations act on the positions of the
slice too; a compaction whose source lies on another rank than its
destination moves the entries' bytes between the ranks: every rank reads
the sources it holds (zeros for the others), one sum over the sp group
gives each rank every source, and each writes the destinations it holds.
"""

from __future__ import annotations

import math

import torch

from ..core.device import resolve_device


def new_storage(shape: tuple, dev: torch.device) -> list[torch.Tensor]:
    """Zeroed flat storages of k, k_scale, v and v_scale for a cache of
    shape [L, S(or P), Hkv, T, D]: rows of D int8 (k, v) or one f32 (the
    scales), one spare row past the L·S·Hkv·T rows of the cache."""
    n, D = math.prod(shape[:-1]), shape[-1]
    kv = (n + 1, D)
    return [torch.zeros(kv, dtype=torch.int8, device=dev),
            torch.zeros(n + 1, dtype=torch.float32, device=dev),
            torch.zeros(kv, dtype=torch.int8, device=dev),
            torch.zeros(n + 1, dtype=torch.float32, device=dev)]


class KVCache:
    def __init__(self, storage: list[torch.Tensor], shape: tuple,
                 mask: torch.Tensor, pos: torch.Tensor):
        """storage: the flat k, k_scale, v, v_scale storages of a cache of
        shape [L, S(or P), Hkv, T, D] (new_storage); self.k etc. are
        views of the rows before the spare one, so building a cache
        copies nothing."""
        self.storage = storage
        self.k, self.k_scale, self.v, self.v_scale = (
            f[:-1].view(s) for f, s in zip(
                storage, (shape, shape[:-1], shape, shape[:-1])))
        self.mask, self.pos = mask, pos

    @classmethod
    def create(cls, n_layers: int, n_slots: int, max_seq: int,
               n_kv_heads: int, head_dim: int,
               device: str | torch.device | None = None) -> "KVCache":
        dev = resolve_device(device)
        shape = (n_layers, n_slots, n_kv_heads, max_seq, head_dim)
        return cls(new_storage(shape, dev), shape,
                   torch.zeros(n_slots, max_seq, dtype=torch.bool, device=dev),
                   torch.zeros(n_slots, dtype=torch.int32, device=dev))

    def clone(self) -> "KVCache":
        """An independent copy: storages, mask and pos."""
        return KVCache([f.clone() for f in self.storage], tuple(self.k.shape),
                       self.mask.clone(), self.pos.clone())

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def n_kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def device(self) -> torch.device:
        return self.k.device

    @staticmethod
    def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[..., H, D] float -> (int8 values, f32 per-[..., H] scale)."""
        xf = x.float()
        scale = xf.abs().amax(dim=-1) / 127.0
        inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale),
                          0.0)
        q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
        return q.to(torch.int8), scale

    def _storage_rows(self, ok: torch.Tensor, slab: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
        """Storage rows [L, S, Tq, Hkv] of the lanes at slab index slab
        [S, Tq] (a slot, or a pool page) and position t [S, Tq] in it,
        for every layer and head; lanes where ok is False go to the spare
        row."""
        L, n_slab, H, T = self.k_scale.shape
        dev = slab.device
        h = torch.arange(H, device=dev)
        rows = (slab[..., None] * H + h) * T + t[..., None]  # [S, Tq, H]
        layer = torch.arange(L, device=dev)[:, None, None, None]
        rows = layer * (n_slab * H * T) + rows[None]
        return torch.where(ok[None, ..., None], rows, L * n_slab * H * T)

    def write_index(self, positions: torch.Tensor) -> torch.Tensor:
        """Storage rows [L, S, Tq, Hkv] that the entries of positions
        [S, Tq] write for every layer and head, out-of-range ones the
        spare row; shared by all layers of one forward. Its shape depends
        on positions.shape only, and nothing is read to the host."""
        S, Tq = positions.shape
        ok = (positions >= 0) & (positions < self.max_seq)
        slot = torch.arange(S, device=positions.device)[:, None].expand(S, Tq)
        return self._storage_rows(ok, slot, torch.where(ok, positions, 0).long())

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
              index: torch.Tensor) -> None:
        """Quantize k_new/v_new [S, Tq, Hkv, D] and store them for one
        layer at `index` (from write_index): every lane, dropped ones on
        the spare row."""
        rows = index[layer]
        (kq, ks), (vq, vs) = self.quantize_kv(k_new), self.quantize_kv(v_new)
        for flat, vals in zip(self.storage, (kq, ks, vq, vs)):
            flat[rows] = vals

    def advance(self, positions: torch.Tensor,
                active: torch.Tensor | None = None,
                visible: torch.Tensor | None = None) -> None:
        """Mark written positions visible and bump pos by the number of
        in-range positions of each active slot. visible [S, Tq] bool:
        False keeps a written position masked (cleared), as a token
        tree's siblings must stay; pos counts it all the same."""
        S = positions.shape[0]
        T = self.max_seq
        dev = self.device
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=dev)
        write = active[:, None] & (positions >= 0) & (positions < T)
        # untouched lanes go to a spare column that is cut off again
        ext = torch.zeros(S, T + 1, dtype=torch.bool, device=dev)
        ext[:, :T] = self.mask
        shown = write if visible is None else write & visible.bool()
        ext.scatter_(1, torch.where(shown, positions.long(), T), True)
        if visible is not None:  # the hidden lanes cleared after the set
            ext.scatter_(1, torch.where(write & ~shown, positions.long(), T),
                         False)
        self.mask.copy_(ext[:, :T])
        self.pos += write.sum(dim=1).to(torch.int32)

    def _slots(self, n, active) -> tuple[torch.Tensor, torch.Tensor]:
        S = self.n_slots
        n = torch.as_tensor(n, dtype=torch.int32, device=self.device)
        n = n.expand(S) if n.dim() == 0 else n
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=self.device)
        return n, active

    def _columns(self) -> torch.Tensor:
        """The global position of each of the mask's columns."""
        return torch.arange(self.max_seq, device=self.device)

    def rollback(self, n, active: torch.Tensor | None = None) -> None:
        """Drop the last n tokens of every active slot."""
        n, active = self._slots(n, active)
        new_pos = torch.clamp(self.pos - torch.where(active, n, 0), min=0)
        self.mask &= self._columns()[None, :] < new_pos[:, None]
        self.pos.copy_(new_pos.to(torch.int32))

    def truncate(self, n, active: torch.Tensor | None = None) -> None:
        """Keep only the first n tokens of every active slot."""
        n, active = self._slots(n, active)
        new_pos = torch.where(active, n, self.pos)
        keep = self._columns()[None, :] < new_pos[:, None]
        self.mask &= keep | ~active[:, None]
        self.pos.copy_(new_pos.to(torch.int32))

    # -- token-tree speculation: in place, fixed shapes, no host read ------

    def set_mask(self, slot, index, value) -> None:
        """Mask or unmask single positions of one slot."""
        self.mask[slot, index] = value

    def _gather_rows(self, src_positions: torch.Tensor, dst: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Storage rows [L, S, n, Hkv] to read (src_positions [S, n], each
        in range) and to write (dst [S, n]; lanes whose source or
        destination is out of range go to the spare row)."""
        S, n = src_positions.shape
        T = self.max_seq
        ok = ((src_positions >= 0) & (src_positions < T) & (dst >= 0)
              & (dst < T))
        slot = torch.arange(S, device=dst.device)[:, None].expand(S, n)
        src = self._storage_rows(torch.ones_like(ok), slot,
                                 src_positions.long().clamp(0, T - 1))
        return src, self._storage_rows(ok, slot,
                                       torch.where(ok, dst, 0).long())

    def gather_tokens(self, slot_indices, src_positions: torch.Tensor,
                      dst_start: torch.Tensor) -> None:
        """Batched compaction: move each slot's cached entries
        src_positions[s, i] (-1: none) to dst_start[s] + i, every layer,
        all read before any is written (a token tree's accepted path). A
        lane whose source or destination is out of range is dropped.
        slot_indices is not read: every slot takes its row."""
        S, n = src_positions.shape
        dst = (dst_start.long()[:, None]
               + torch.arange(n, device=src_positions.device)[None, :])
        src, dst = self._gather_rows(src_positions, dst)
        for flat in self.storage:
            flat[dst] = flat[src]

    def commit_tokens(self, slot_indices, src_positions: torch.Tensor,
                      n_accept: torch.Tensor) -> None:
        """A token tree's acceptance: each slot's accepted entries
        src_positions [S, n] (in acceptance order, -1 past n_accept [S])
        move to pos .. pos + n_accept - 1, the mask is set there and pos
        grows by n_accept."""
        start = self.pos.long()
        self.gather_tokens(slot_indices, src_positions, start)
        end = start + n_accept.long()
        col = self._columns()[None, :]
        self.mask |= (col >= start[:, None]) & (col < end[:, None])
        self.pos += n_accept.to(torch.int32)

    def copy_token(self, slot, dst, src) -> None:
        """Copy one cached entry src -> dst within a slot, every layer."""
        S = self.n_slots
        dev = self.device
        rows = torch.arange(S, device=dev)
        src = torch.where(rows == torch.as_tensor(slot, device=dev),
                          torch.as_tensor(src, device=dev).long(), -1)
        self.gather_tokens(rows, src[:, None],
                           torch.as_tensor(dst, device=dev).long().expand(S))

    def reset_slot(self, slot: int) -> None:
        """Clear one slot."""
        self.mask[slot] = False
        self.pos[slot] = 0

    def n_local(self, n: int) -> int:
        """How many of a slot's first n positions this cache holds."""
        return n

    def save_slot_prefix(self, slot: int, n: int) -> dict:
        """Snapshot the first n cached tokens of one slot: copies, so
        later writes into the slot leave the snapshot as it was (a prompt
        prefix cache entry). Format: {"n", "k", "v" [L, H, n, D],
        "k_scale", "v_scale" [L, H, n]}, shared with the paged pool."""
        return {"n": n,
                "k": self.k[:, slot, :, :n].clone(),
                "v": self.v[:, slot, :, :n].clone(),
                "k_scale": self.k_scale[:, slot, :, :n].clone(),
                "v_scale": self.v_scale[:, slot, :, :n].clone()}

    def restore_slot_prefix(self, slot: int, saved: dict) -> None:
        """Write a saved prefix into a slot; mask/pos cover exactly it."""
        n = saved["n"]
        for name in ("k", "v", "k_scale", "v_scale"):
            getattr(self, name)[:, slot, :, :n] = saved[name]
        self.mask[slot] = torch.arange(self.max_seq, device=self.device) < n
        self.pos[slot] = n

    # -- snapshots on the host (kv/persist.py: prefix and session files) -----

    def check_snapshot(self, host: dict) -> None:
        """Raise a ValueError if a host snapshot ({"n", "k", "v",
        "k_scale", "v_scale"}, k [L, H, n, D]) does not fit this cache."""
        n, shape = int(host["n"]), tuple(host["k"].shape)
        want = (self.n_layers, self.n_kv_heads, n, self.head_dim)
        if shape != want:
            raise ValueError(f"KV shape mismatch: {shape} vs {want} "
                             f"[layers, kv heads, n, head dim]")
        if n > self.max_seq:
            raise ValueError(f"prefix ({n}) exceeds cache ({self.max_seq})")

    def snapshot_from_host(self, host: dict) -> dict:
        """A host snapshot as a save_slot_prefix snapshot on this cache's
        device, checked first (check_snapshot)."""
        self.check_snapshot(host)
        out = {"n": int(host["n"])}
        for name, dt in (("k", torch.int8), ("v", torch.int8),
                         ("k_scale", torch.float32),
                         ("v_scale", torch.float32)):
            out[name] = torch.as_tensor(host[name]).to(self.device, dt,
                                                        copy=True)
        return out

    def snapshot_to_host(self, saved: dict) -> dict:
        """A save_slot_prefix snapshot as host arrays {"n", "k", "v",
        "k_scale", "v_scale"}."""
        return {"n": int(saved["n"]),
                **{name: saved[name].cpu().numpy()
                   for name in ("k", "v", "k_scale", "v_scale")}}


class SeqShardCache(KVCache):
    """Sequence-parallel rank `sp_rank` of `sp`: positions [t0, t0 + T) of
    a dense cache of max_seq = sp * T positions (T = k.shape[3]); pos is
    global (every rank's the same). comm: the sp group's TPComm, which
    the token-tree compaction sums over (None: this slice alone)."""

    def __init__(self, storage: list[torch.Tensor], shape: tuple,
                 mask: torch.Tensor, pos: torch.Tensor, t0: int,
                 total: int, comm=None):
        super().__init__(storage, shape, mask, pos)
        self.t0, self.total = int(t0), int(total)
        self.comm = comm

    @classmethod
    def create(cls, n_layers: int, n_slots: int, max_seq: int,
               n_kv_heads: int, head_dim: int,
               device: str | torch.device | None = None, *, sp: int,
               sp_rank: int, comm=None) -> "SeqShardCache":
        if max_seq % sp:
            raise ValueError(f"max_seq {max_seq} does not split over "
                             f"sp={sp}")
        dev = resolve_device(device)
        t = max_seq // sp
        shape = (n_layers, n_slots, n_kv_heads, t, head_dim)
        return cls(new_storage(shape, dev), shape,
                   torch.zeros(n_slots, t, dtype=torch.bool, device=dev),
                   torch.zeros(n_slots, dtype=torch.int32, device=dev),
                   sp_rank * t, max_seq, comm)

    def clone(self) -> "SeqShardCache":
        return SeqShardCache([f.clone() for f in self.storage],
                             tuple(self.k.shape), self.mask.clone(),
                             self.pos.clone(), self.t0, self.total,
                             self.comm)

    @property
    def max_seq(self) -> int:
        return self.total

    @property
    def t_local(self) -> int:
        return self.k.shape[3]

    def local(self, positions: torch.Tensor) -> torch.Tensor:
        """Global positions as this slice's (-1 where another rank's)."""
        p = positions.long() - self.t0
        return torch.where((p >= 0) & (p < self.t_local), p, -1)

    def _columns(self) -> torch.Tensor:
        return self.t0 + torch.arange(self.t_local, device=self.device)

    def n_local(self, n: int) -> int:
        return min(max(n - self.t0, 0), self.t_local)

    def write_index(self, positions: torch.Tensor) -> torch.Tensor:
        S, Tq = positions.shape
        loc = self.local(positions)
        ok = loc >= 0
        slot = torch.arange(S, device=positions.device)[:, None].expand(S, Tq)
        return self._storage_rows(ok, slot, torch.where(ok, loc, 0))

    def advance(self, positions: torch.Tensor,
                active: torch.Tensor | None = None,
                visible: torch.Tensor | None = None) -> None:
        S, T = positions.shape[0], self.t_local
        dev = self.device
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=dev)
        counted = active[:, None] & (positions >= 0) & (positions < self.total)
        loc = self.local(positions)
        write = counted & (loc >= 0)
        ext = torch.zeros(S, T + 1, dtype=torch.bool, device=dev)
        ext[:, :T] = self.mask
        shown = write if visible is None else write & visible.bool()
        ext.scatter_(1, torch.where(shown, loc, T), True)
        if visible is not None:
            ext.scatter_(1, torch.where(write & ~shown, loc, T), False)
        self.mask.copy_(ext[:, :T])
        self.pos += counted.sum(dim=1).to(torch.int32)

    # -- token trees over the slice ------------------------------------------

    def set_mask(self, slot, index, value) -> None:
        """Mask or unmask the global positions `index` of one slot that
        lie in this slice."""
        T = self.t_local
        loc = self.local(torch.as_tensor(index, device=self.device))
        row = torch.cat([self.mask[slot], self.mask.new_zeros(1)])
        row[torch.where(loc >= 0, loc, T)] = value
        self.mask[slot] = row[:T]

    def gather_tokens(self, slot_indices, src_positions: torch.Tensor,
                      dst_start: torch.Tensor) -> None:
        """KVCache.gather_tokens in global positions: each source is read
        on the rank that holds it, summed over the sp group (the others
        add zeros; the scales as their int32 bits, so the sum is the
        bytes), and written where this slice holds the destination."""
        S, n = src_positions.shape
        dev = src_positions.device
        T = self.total
        dst = (dst_start.long()[:, None]
               + torch.arange(n, device=dev)[None, :])
        ok = ((src_positions >= 0) & (src_positions < T) & (dst >= 0)
              & (dst < T))
        src_loc, dst_loc = self.local(src_positions), self.local(dst)
        slot = torch.arange(S, device=dev)[:, None].expand(S, n)
        held = ok & (src_loc >= 0)
        src = self._storage_rows(held, slot, torch.where(held, src_loc, 0))
        put = ok & (dst_loc >= 0)
        dst = self._storage_rows(put, slot, torch.where(put, dst_loc, 0))
        moved = []
        for flat in self.storage:  # [L, S, n, Hkv(, D)] as int32
            v = flat[src]
            v = v.to(torch.int32) if v.dtype == torch.int8 else v.view(
                torch.int32)
            keep = held.view(1, S, n, *(1,) * (v.dim() - 3))
            moved.append(torch.where(keep, v, 0))
        if self.comm is not None:
            summed = self.comm.all_reduce(torch.cat(
                [m.reshape(-1) for m in moved]))
            moved = [b.view(m.shape) for b, m in zip(
                summed.split([m.numel() for m in moved]), moved)]
        for flat, v in zip(self.storage, moved):
            flat[dst] = (v.to(torch.int8) if flat.dtype == torch.int8
                         else v.view(flat.dtype))

    def save_slot_prefix(self, slot: int, n: int) -> dict:
        """This slice's part of the slot's first n positions: {"n": n,
        "k", "v" [L, H, n_local(n), D], "k_scale", "v_scale"}."""
        m = self.n_local(n)
        return {"n": n,
                **{name: getattr(self, name)[:, slot, :, :m].clone()
                   for name in ("k", "v", "k_scale", "v_scale")}}

    def restore_slot_prefix(self, slot: int, saved: dict) -> None:
        n = saved["n"]
        m = self.n_local(n)
        for name in ("k", "v", "k_scale", "v_scale"):
            getattr(self, name)[:, slot, :, :m] = saved[name]
        self.mask[slot] = self._columns() < n
        self.pos[slot] = n
