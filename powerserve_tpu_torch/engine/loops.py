"""Bench-style entry over the forward: one prefill chunk, and a greedy
decode loop whose head returns the argmax tokens (the fused head's
argmax epilogue), so logits never leave the kernel. The KV cache is
updated in place.

decode_scan replays one decode step as a CUDA graph per step
(engine/graphs.py), as the JAX package runs its steps in one compiled
scan; decode_scan_eager is its twin, a Python loop over eager forwards.
"""

from __future__ import annotations

import weakref

import torch

from ..kv.cache import KVCache
from ..models.llama import LlamaModel
from .graphs import graphs_of, steps_capacity


@torch.no_grad()
def prefill_step(model: LlamaModel, tokens: torch.Tensor,
                 positions: torch.Tensor, kv: KVCache) -> torch.Tensor:
    """One prefill chunk: tokens/positions [S, T] -> last logits [S, V]."""
    return model(kv, tokens, positions, logits_mode="last")


def _scan_step(model: LlamaModel, kv: KVCache, S: int, cap: int) -> tuple:
    """The body of one greedy step and its buffers: the token buffer
    [S] feeds the step and takes its argmax, which also goes to column
    `step` of out [S, cap]."""
    dev = kv.device
    tok = torch.zeros(S, dtype=torch.int64, device=dev)
    out = torch.zeros(S, cap, dtype=torch.int32, device=dev)
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    model_ref, kv_ref = weakref.ref(model), weakref.ref(kv)

    def body():
        c = kv_ref()
        nxt = model_ref()(c, tok[:, None], c.pos.to(torch.int64)[:, None],
                          logits_mode="argmax")
        tok.copy_(nxt)
        out.index_copy_(1, step, nxt[:, None])
        step.add_(1)

    return body, dict(tok=tok, out=out, step=step)


@torch.no_grad()
def decode_scan(model: LlamaModel, tokens: torch.Tensor, kv: KVCache,
                n_steps: int) -> torch.Tensor:
    """Greedy-decode n_steps tokens for every slot, each slot at its own
    kv.pos. tokens: [S] current token per slot. Returns [S, n_steps]
    (int32). One step graph per (cache, model, slots, step capacity),
    kept with the cache."""
    S = tokens.shape[0]
    cap = steps_capacity(n_steps)
    g = graphs_of(kv).step(("decode_scan", S, cap),
                           lambda: _scan_step(model, kv, S, cap),
                           deps=(model,))
    g.bufs["tok"].copy_(tokens)
    g.bufs["step"].zero_()
    for _ in range(n_steps):
        g()
    return g.bufs["out"][:, :n_steps].clone()


@torch.no_grad()
def decode_scan_eager(model: LlamaModel, tokens: torch.Tensor, kv: KVCache,
                      n_steps: int) -> torch.Tensor:
    """decode_scan's twin: a Python loop over eager forwards."""
    out = []
    tok = tokens
    for _ in range(n_steps):
        pos = kv.pos.to(torch.int64)[:, None]
        tok = model(kv, tok[:, None], pos, logits_mode="argmax")
        out.append(tok)
    return torch.stack(out, dim=1)
