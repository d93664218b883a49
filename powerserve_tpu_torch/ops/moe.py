"""MoE grouped top-k dispatch: the (token, expert) assignments sorted by
expert, each expert's segment padded to the grouped matmul's M tile, so
one qmatmul_grouped call (ops/qmatmul.py) computes only the routed pairs
and each M tile reads only its expert's slab.

Static shapes throughout (capacity = assignments + one pad tile per
routed expert, nothing is dropped) and no host read of the routed ids:
sort, cumulative sums, searchsorted and scatters on the device, as the
JAX package's ops/moe.py does with jnp.
"""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def group_dispatch(topi: torch.Tensor, topw: torch.Tensor, n_local: int,
                   e_off: torch.Tensor | int, block_m: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sorted and padded grouped-matmul layout of one MoE layer.

    topi/topw: [N, k] routed expert ids (global) and renormalized
    weights. n_local: experts owned here; e_off: the first of them
    (0 without expert parallelism). block_m: the grouped matmul's M tile.

    Returns (tok [P], w [P], tile_e [P // block_m]) as the JAX function:
      tok: source token row of each padded slot (-1 for padding),
      w: routing weight of each slot (0 for padding and non-local),
      tile_e: local expert id of each M tile (tiles past the routed
      segments point at the last local expert; their rows carry w = 0).
    P = round_up(N*k, block_m) + min(N*k, n_local) * block_m bounds the
    padded segments for any routing."""
    n, k = topi.shape
    a = n * k
    bm = int(block_m)
    p = round_up(a, bm) + min(a, n_local) * bm
    dev = topi.device
    e_flat = topi.reshape(-1).to(torch.int64) - e_off
    w_flat = topw.reshape(-1).float()
    tok = torch.arange(a, device=dev) // k
    local = (e_flat >= 0) & (e_flat < n_local)
    # non-local assignments sort into a trailing bucket and drop
    key = torch.where(local, e_flat, n_local)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    tok_s = tok[order]
    w_s = torch.where(local, w_flat, 0.0)[order]
    counts = torch.zeros(n_local + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    seg_start = torch.cumsum(counts, 0) - counts
    padded = (counts[:n_local] + bm - 1) // bm * bm
    pad_end = torch.cumsum(padded, 0)
    pad_start = pad_end - padded
    rank = torch.arange(a, device=dev) - seg_start[key_s]
    dst = torch.where(key_s < n_local,
                      pad_start[key_s.clamp(max=n_local - 1)] + rank, p)
    # slot p is the drop bucket
    tok_p = torch.full((p + 1,), -1, dtype=torch.int32, device=dev)
    tok_p.scatter_(0, dst, tok_s.to(torch.int32))
    w_p = torch.zeros(p + 1, dtype=torch.float32, device=dev)
    w_p.scatter_(0, dst, w_s)
    starts = torch.arange(p // bm, device=dev) * bm
    tile_e = torch.searchsorted(pad_end, starts, right=True)
    tile_e = tile_e.clamp(max=n_local - 1).to(torch.int32)
    return tok_p[:p], w_p[:p], tile_e


def combine(y: torch.Tensor, tok: torch.Tensor, w: torch.Tensor,
            n_tokens: int, k: int) -> torch.Tensor:
    """Weighted sum of each token's expert rows: y [P, dim] grouped-matmul
    output, tok/w from group_dispatch, k the assignments per token (a
    token holds at most k rows). Returns f32 [n_tokens, dim].

    Deterministic: no atomics. Each token's rows are gathered and added
    in the order they lie in y (by expert), the order in which the JAX
    package's scatter-add takes them."""
    p = tok.shape[0]
    dev = y.device
    key = torch.where(tok >= 0, tok.long(), n_tokens)
    order = torch.argsort(key, stable=True)  # rows by token, then by row
    counts = torch.zeros(n_tokens + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    start = (torch.cumsum(counts, 0) - counts)[:n_tokens]
    contrib = y.float() * w[:, None]
    out = torch.zeros(n_tokens, y.shape[-1], dtype=torch.float32, device=dev)
    for j in range(k):
        row = order[(start + j).clamp(max=p - 1)]
        have = (j < counts[:n_tokens])[:, None]
        out = out + torch.where(have, contrib[row], 0.0)
    return out
