"""Masked GQA attention over the int8 KV cache (plain PyTorch).

The visibility mask combines the cache's mask with the new batch's
positions, so one code path serves chunked prefill and decode. The model
attends through the kernels (ops/flash_decode.py for decode-sized
batches, ops/flash_prefill.py for prefill chunks); `gqa_attention_quant`
is the one-softmax reference the tests hold their twins against.
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
