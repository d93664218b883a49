"""Bench-style entry over the forward: one prefill chunk, and a greedy
decode loop whose head returns the argmax tokens (the fused head's
argmax epilogue), so logits never leave the kernel. Python loops over
the steps; the KV cache is updated in place."""

from __future__ import annotations

import torch

from ..kv.cache import KVCache
from ..models.llama import LlamaModel


@torch.no_grad()
def prefill_step(model: LlamaModel, tokens: torch.Tensor,
                 positions: torch.Tensor, kv: KVCache) -> torch.Tensor:
    """One prefill chunk: tokens/positions [S, T] -> last logits [S, V]."""
    return model(kv, tokens, positions, logits_mode="last")


@torch.no_grad()
def decode_scan(model: LlamaModel, tokens: torch.Tensor, kv: KVCache,
                n_steps: int) -> torch.Tensor:
    """Greedy-decode n_steps tokens for every slot, each slot at its own
    kv.pos. tokens: [S] current token per slot. Returns [S, n_steps]."""
    out = []
    tok = tokens
    for _ in range(n_steps):
        pos = kv.pos.to(torch.int64)[:, None]
        tok = model(kv, tok[:, None], pos, logits_mode="argmax")
        out.append(tok)
    return torch.stack(out, dim=1)
