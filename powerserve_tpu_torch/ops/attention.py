"""Masked GQA attention over the int8 KV cache (plain PyTorch).

The visibility mask combines the cache's mask with the new batch's
positions, so one code path serves chunked prefill and decode. The model
attends through the kernels (ops/flash_decode.py for decode-sized
batches, ops/flash_prefill.py for prefill chunks); `gqa_attention_quant`
is the one-softmax reference the tests hold their twins against.

`gqa_attention_quant_sp` is a sequence-parallel rank's attention (the
JAX gqa_attention_quant_sp): the state mode of a kernel over the rank's
time slice of the cache, then the softmax merged over the sp ranks by
one max and one sum (of l and o side by side). The collectives and the
merge are plain PyTorch, as the JAX package computes them in XLA outside
its kernels.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def build_visibility(cache_mask: torch.Tensor, positions: torch.Tensor,
                     intra_mask: torch.Tensor | None = None) -> torch.Tensor:
    """cache_mask [S, T] bool (tokens already appended); positions
    [S, J] (where the key tokens are written: the new batch's own, or a
    token tree's nodes); intra_mask [Tq, J] bool (query q sees key j: a
    tree's ancestor rows) or None (causal over the batch, J = Tq: query
    q sees new token j <= q). Returns visibility [S, Tq, T] bool."""
    S, T = cache_mask.shape
    dev = cache_mask.device
    if intra_mask is None:
        qi = torch.arange(positions.shape[1], device=dev)
        intra_mask = qi[None, :] <= qi[:, None]
    t = torch.arange(T, device=dev)
    eq = (t[None, None, :] == positions[:, :, None]).float()  # [S, j, T]
    vis_new = torch.einsum("qj,sjt->sqt", intra_mask.float(), eq) > 0.5
    return cache_mask[:, None, :] | vis_new


def gqa_attention_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                        vq: torch.Tensor, vs: torch.Tensor,
                        visibility: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention straight over the int8 cache, per-token scales folded
    into the scores and probabilities:

      scores[.., t] = (bf16(q) . kq[t]) * (ks[t] * scale)
      out = sum_t bf16(p[t] * vs[t]) * vq[t]

    q [S, Tq, H, D]; kq/vq int8 [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T];
    visibility [S, Tq, T] bool. Returns f32 [S, Tq, H * D]. Operands are
    rounded to bf16 and multiplied in f32 (the JAX package's TPU
    numerics)."""
    S, Tq, H, D = q.shape
    Hkv = kq.shape[1]
    G = H // Hkv
    qg = q.reshape(S, Tq, Hkv, G, D).to(torch.bfloat16).float()
    scores = torch.einsum("sqhgd,shkd->shgqk", qg, kq.float())
    scores = scores * (ks[:, :, None, None, :] * scale)
    scores = torch.where(visibility[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    pf = (probs * vs[:, :, None, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("shgqk,shkd->sqhgd", pf, vq.float())
    return out.reshape(S, Tq, H * D)


def gqa_attention_quant_sp(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, mask: torch.Tensor,
                           positions: torch.Tensor, scale: float, comm,
                           t0: int, bits: torch.Tensor | None = None,
                           prefill: bool = False) -> torch.Tensor:
    """Sequence-parallel attention of one rank: kq/vq int8 [S, Hkv, T, D],
    ks/vs [S, Hkv, T] and mask [S, T] are its slice of the time axis,
    global positions t0 .. t0 + T - 1; q [S, Tq, H, D] and positions
    [S, Tq] (global; with bits, the decode tree mode's key positions) the
    same on every rank. Decode-sized batches take flash-decode's state
    mode, prefill chunks (prefill=True: each slot's rows contiguous from
    positions[:, 0]) flash-prefill's. The states (o [S, R, D], m, l
    [S, R]; R = (h, g, tq), tq minor) merge as JAX's shards do: m_max the
    max of m over comm, each rank's weight exp(m - m_max), or 0 for a row
    it does not see (m <= NEG_INF / 2), l and o summed with that weight
    (one sum of the two side by side, where JAX runs two), o / l.
    Returns f32 [S, Tq, H * D]."""
    from .flash_decode import flash_decode_quant
    from .flash_prefill import flash_prefill_quant

    if prefill:
        o, m, l = flash_prefill_quant(q, kq, ks, vq, vs, mask,
                                      positions[:, 0], scale, state=True,
                                      t0=t0)
    else:
        o, m, l = flash_decode_quant(q, kq, ks, vq, vs, mask, positions,
                                     scale, bits=bits, state=True, t0=t0)
    S, Tq, H, D = q.shape
    m_max = comm.all_reduce(m.clone(), "max")
    w = torch.where(m > NEG_INF / 2, torch.exp(m - m_max), 0.0)
    ol = comm.all_reduce(torch.cat([o, l[..., None]], dim=-1)
                         * w[..., None])
    out = ol[..., :D] / torch.where(ol[..., D] > 0, ol[..., D],
                                    1.0)[..., None]
    return out.reshape(S, H, Tq, D).transpose(1, 2).reshape(S, Tq, H * D)
