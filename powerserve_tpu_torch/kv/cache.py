"""INT8 KV cache with mask / rollback semantics, updated in place.

Layout: k/v int8 [n_layers, n_slots, n_kv_heads, max_seq, head_dim] —
the sequence axis sits inside each head so a (slot, head) slab is
contiguous [T, D] for the attention kernel; per-(token, head) f32 scales
[L, S, Hkv, T]; mask [S, T] bool (positions visible to attention); pos
[S] int32 (stored tokens per slot, the next write index).

The JAX package updates the cache functionally; here writes go into the
same tensors, and the contents match the JAX cache entry for entry.
Positions outside [0, max_seq) — inactive slots are fed -1 — are dropped,
as JAX's scatter mode="drop" drops them.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: torch.Tensor, v_scale: torch.Tensor,
                 mask: torch.Tensor, pos: torch.Tensor):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale
        self.mask, self.pos = mask, pos

    @classmethod
    def create(cls, n_layers: int, n_slots: int, max_seq: int,
               n_kv_heads: int, head_dim: int,
               device: str | torch.device | None = None) -> "KVCache":
        dev = resolve_device(device)
        shape = (n_layers, n_slots, n_kv_heads, max_seq, head_dim)
        return cls(torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                   torch.zeros(n_slots, max_seq, dtype=torch.bool, device=dev),
                   torch.zeros(n_slots, dtype=torch.int32, device=dev))

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

    def write_index(self, positions: torch.Tensor) -> tuple:
        """(slot, batch column, cache position) of every in-range entry
        of positions [S, Tq]; shared by all layers of one forward."""
        ok = (positions >= 0) & (positions < self.max_seq)
        s_idx, t_idx = ok.nonzero(as_tuple=True)
        return s_idx, t_idx, positions[s_idx, t_idx].long()

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
              index: tuple) -> None:
        """Quantize k_new/v_new [S, Tq, Hkv, D] and store them for one
        layer at `index` (from write_index)."""
        s_idx, t_idx, p = index
        for cache, scales, new in ((self.k, self.k_scale, k_new),
                                   (self.v, self.v_scale, v_new)):
            qv, sv = self.quantize_kv(new)
            cache[layer][s_idx, :, p] = qv[s_idx, t_idx]
            scales[layer][s_idx, :, p] = sv[s_idx, t_idx]

    def advance(self, positions: torch.Tensor,
                active: torch.Tensor | None = None) -> None:
        """Mark written positions visible and bump pos by the number of
        in-range positions of each active slot."""
        S = positions.shape[0]
        T = self.max_seq
        dev = self.device
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=dev)
        write = active[:, None] & (positions >= 0) & (positions < T)
        # untouched lanes go to a spare column that is cut off again
        ext = torch.zeros(S, T + 1, dtype=torch.bool, device=dev)
        ext[:, :T] = self.mask
        ext.scatter_(1, torch.where(write, positions.long(), T), True)
        self.mask.copy_(ext[:, :T])
        self.pos += write.sum(dim=1).to(torch.int32)

    def _slots(self, n, active) -> tuple[torch.Tensor, torch.Tensor]:
        S = self.n_slots
        n = torch.as_tensor(n, dtype=torch.int32, device=self.device)
        n = n.expand(S) if n.dim() == 0 else n
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=self.device)
        return n, active

    def rollback(self, n, active: torch.Tensor | None = None) -> None:
        """Drop the last n tokens of every active slot."""
        n, active = self._slots(n, active)
        new_pos = torch.clamp(self.pos - torch.where(active, n, 0), min=0)
        col = torch.arange(self.max_seq, device=self.device)
        self.mask &= col[None, :] < new_pos[:, None]
        self.pos.copy_(new_pos.to(torch.int32))

    def truncate(self, n, active: torch.Tensor | None = None) -> None:
        """Keep only the first n tokens of every active slot."""
        n, active = self._slots(n, active)
        new_pos = torch.where(active, n, self.pos)
        col = torch.arange(self.max_seq, device=self.device)
        keep = col[None, :] < new_pos[:, None]
        self.mask &= keep | ~active[:, None]
        self.pos.copy_(new_pos.to(torch.int32))

    def reset_slot(self, slot: int) -> None:
        """Clear one slot."""
        self.mask[slot] = False
        self.pos[slot] = 0
