"""Llama-family transformer (llama, qwen2 = llama + QKV bias, qwen3 =
llama + QK-norm, and mixture-of-experts FFNs as in Mixtral and
Qwen3-MoE): the JAX package's forward as nn.Modules with a Python loop
over the layers.

LlamaLayer holds one layer's weights (the JAX LayerWeights, unstacked)
and LlamaModel the embedding, the layers, the final norm and the
lm_head (the JAX LlamaParams). Numerics follow the JAX package: bf16
residual stream, f32 norms, quantized matmuls with bf16 inputs and f32
outputs, int8 KV cache with per-(token, head) scales.

By default (kv_update="inline") each layer writes its new K/V into the
cache in place before attention (the JAX main path defers the write past
the layer scan to dodge an XLA aliasing cost; the cache contents are the
same). Decode-sized batches (Tq <= 16) attend through the flash-decode
kernel, which forms build_visibility's [S, Tq, T] visibility from the
cache mask and the positions itself; larger batches are prefill chunks
(each slot's real lanes contiguous from positions[:, 0], padding at the
end) and attend through the flash-prefill kernel, which computes that
visibility itself too. The cache is the dense KVCache or the paged pool
(kv/paged.py): paged decode reads the pool through the page table in
the paged flash-decode kernel; paged prefill attends over the gathered
slot view, as the JAX package does.

Speculation adds three options of the JAX forward. fuse_layers=True runs
each decode-sized layer as the fused chain of ops/fused.py (norm + bias ->
QKV, x -> wo, norm(x + attn_out) -> gate|up, glu + both residuals ->
down: four fused launches, the layer output rounded to bf16 once), as
the JAX package does for drafts of at most 4 layers. logits_mode
"argmax_all" gives the greedy token of every row (a chain verify), and a
LlamaModel with `lm_head_lr` = (U, V) runs its head as norm -> U, then
V with the argmax (the factored draft head). kv_update="deferred" on the
paged pool (decode-sized batches, the paged verify of speculation)
writes nothing before attention: each layer quantizes its new K/V and
attends to them as an in-flight block beside the committed pages
(ops/flash_decode.py: flash_decode_paged_deferred, the state mode of the
paged kernel), and one commit after the layer loop stores every layer's
K/V through the page table. return_final_hidden=True also returns the
last layer's pre-norm hidden states, the features an EAGLE head drafts
from (speculative/eagle.py, which runs LlamaLayer on an f32 residual
stream, its first layer without the attention norm).

Sequence parallelism (parallel/tp.py, a mesh's sp axis): a LlamaModel
whose `sp` is a TPComm attends over a SeqShardCache, its rank's slice of
the cache's time axis, through the kernels' state modes, and merges the
ranks' softmax states (ops/attention.py gqa_attention_quant_sp); RoPE and
the positions stay global, and the cache drops the writes that belong to
another rank's slice (the JAX forward's sp_axis). Pipeline parallelism
(parallel/pp.py) runs a stage's layers as this forward with the previous
stage's residual as `embeds` and return_final_hidden=True.

Tensor parallelism (parallel/tp.py): a LlamaModel whose `tp` is a
TPComm (parallel/mesh.py) holds one rank's shards, with the local head
counts in its llm, and its forward runs the megatron collectives of the
JAX forward's tp_axis: a vocab-sharded embedding is a masked lookup,
then an all_reduce; wo and down are row-parallel, so their f32 products
are all_reduced before the residual adds (on the fused route too: down's
epilogue then takes no residuals, which each rank would add once); a
vocab-sharded lm_head's logits are gathered over the ranks, and its
greedy argmax is the argmax over the whole vocab (the first index on
ties) from each rank's (max, index). Without `tp` nothing changes.

An MoE layer routes each token to its top n_experts_used experts (f32
router, softmax, top-k, weights renormalized) and runs the expert FFNs
on a route chosen from the shapes alone (moe_route): a single token
reads only its k routed slabs; any larger batch goes through the grouped
dispatch (ops/moe.py, qmatmul_grouped), in tiles of GROUPED_MMA_M rows
from MOE_GROUP_MIN rows on, else of GEMV_MAX_M. The JAX package also
has a dense route, every expert on every row, for decode batches whose
grouped layout reads as many slabs as all experts; on the H100 it took
longer than the grouped route at every batch measured
(tools/moe_routes.py), so the port leaves it out. No route reads the
routed ids on the host.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.config import LLMConfig
from ..core.quant import QK
from ..kv.cache import KVCache, SeqShardCache
from ..kv.paged import PagedKVCache
from ..ops.attention import gqa_attention_quant_sp
from ..ops.elementwise import apply_rope, rms_norm, rope_cos_sin, silu_hadamard
from ..ops.flash_decode import (flash_decode_paged,
                                flash_decode_paged_deferred,
                                flash_decode_quant, pack_intra)
from ..ops.flash_prefill import flash_prefill_quant
from ..ops.fused import FUSED_MAX_M, fused_linear
from ..ops.moe import combine, group_dispatch
from ..ops.qmatmul import (GEMV_MAX_M, GROUPED_MMA_M, QLinear, qmatmul,
                           qmatmul_grouped)

# the largest query batch that attends through the flash-decode kernel
DECODE_MAX_TQ = 16
# MoE dispatch: the batch from which the grouped route takes the
# tensor-core tile (the JAX package's default, models/llama.py)
MOE_GROUP_MIN = 64


def moe_route(rows: int) -> tuple[str, int]:
    """(route, block_m) of an MoE FFN over `rows` token rows: "single"
    or "grouped"."""
    if rows == 1:
        return "single", 1
    return "grouped", GROUPED_MMA_M if rows >= MOE_GROUP_MIN else GEMV_MAX_M


def attention(kv: KVCache, layer: int, q: torch.Tensor,
              positions: torch.Tensor, scale: float,
              bits: torch.Tensor | None = None,
              mask: torch.Tensor | None = None, sp=None) -> torch.Tensor:
    """One layer's attention over the cache (the new K/V already
    written): q [S, Tq, H, D]; positions int32 [S, Tq] (causal), or with
    bits (int32 [Tq], a token tree's rows: ops/flash_decode.py) the key
    positions [S, J]; mask [S, T] the committed visibility (default
    kv.mask, as before this batch). sp: the TPComm of the sequence-
    parallel ranks, kv a SeqShardCache (the kernels' state modes over its
    slice, merged: gqa_attention_quant_sp), mask [S, max_seq] over every
    position (the slice's columns taken here). Returns f32
    [S, Tq, H * D]."""
    slabs = (kv.k[layer], kv.k_scale[layer], kv.v[layer], kv.v_scale[layer])
    decode = q.shape[1] <= DECODE_MAX_TQ
    if sp is not None:
        if not isinstance(kv, SeqShardCache):
            raise ValueError("sequence parallelism takes the dense int8 "
                             "cache's slices")
        mask = (kv.mask if mask is None
                else mask[:, kv.t0:kv.t0 + kv.t_local])
        return gqa_attention_quant_sp(q, *slabs, mask, positions, scale,
                                      sp, kv.t0, bits, prefill=not decode)
    mask = kv.mask if mask is None else mask
    if isinstance(kv, PagedKVCache):
        if decode:
            return flash_decode_paged(q, *slabs, kv.page_table, mask,
                                      positions, scale, bits=bits)
        slabs = tuple(kv.gather_slab(t) for t in slabs)
    if decode:
        return flash_decode_quant(q, *slabs, mask, positions, scale,
                                  bits=bits)
    return flash_prefill_quant(q, *slabs, mask, positions[:, 0], scale)


class DeferredKV:
    """The deferred route of one forward over the paged pool: each layer's
    quantized new K/V attend as an in-flight block and are kept for the
    one commit after the layer loop."""

    def __init__(self, kv: PagedKVCache, positions: torch.Tensor,
                 intra: torch.Tensor | None = None):
        """positions [S, Tq] where the new rows go; intra [Tq, Tq] bool,
        which new rows each row sees (default causal; a token tree's
        ancestor rows)."""
        S, Tq = positions.shape
        valid = (positions >= 0) & (positions < kv.max_seq)
        if intra is None:
            intra = torch.ones(Tq, Tq, dtype=torch.bool,
                               device=positions.device).tril()
        self.intra = intra.bool()[None] & valid[:, None, :]  # [S, Tq, Tq]
        self.blocks: list[tuple] = []

    def attend(self, kv: PagedKVCache, layer: int, q: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
        kq, ks = kv.quantize_kv(k)  # [S, Tq, Hkv, D], [S, Tq, Hkv]
        vq, vs = kv.quantize_kv(v)
        self.blocks.append((kq, ks, vq, vs))
        heads_first = lambda t: t.transpose(1, 2)  # noqa: E731
        return flash_decode_paged_deferred(
            q, kv.k[layer], kv.k_scale[layer], kv.v[layer], kv.v_scale[layer],
            kv.page_table, kv.mask, heads_first(kq), heads_first(ks),
            heads_first(vq), heads_first(vs), self.intra, scale)


def vocab_rows(embed: "QEmbedding", tokens: torch.Tensor, vocab: int,
               tp=None) -> torch.Tensor:
    """The rows f32 [..., dim] of tokens in a table of `vocab` rows, or
    in a rank's vocab shard of it (tp: the TPComm; each id's row on one
    rank, zeros elsewhere, summed over the ranks)."""
    n = embed.q.shape[0]
    if tp is None or n == vocab:
        return embed.lookup(tokens)
    local = tokens.long() - tp.rank * n
    ok = (local >= 0) & (local < n)
    x = embed.lookup(torch.where(ok, local, 0))
    return tp.all_reduce(torch.where(ok[..., None], x, 0.0))


def vocab_linear(lin: QLinear, vocab: int, tp=None, argmax: bool = False,
                 **prologue) -> torch.Tensor:
    """fused_linear(lin, **prologue) over a head of `vocab` columns (+ the
    greedy argmax), or over a rank's vocab shard of it: the logits
    gathered over the ranks, or the argmax over the whole vocab (the
    first index on ties) from each rank's (max, index)."""
    if tp is None or lin.out_features == vocab:
        return fused_linear(lin, argmax=argmax, **prologue)
    y = fused_linear(lin, **prologue)  # this rank's columns
    n = y.shape[-1]
    if argmax:
        i = y.argmax(dim=-1)
        v = y.gather(-1, i[:, None])[:, 0]
        top = tp.all_reduce(v.clone(), "max")
        cand = torch.where(v == top, i + tp.rank * n, n * tp.size)
        return tp.all_reduce(cand, "min").to(torch.int32)
    full = y.new_zeros(y.shape[0], n * tp.size)
    full[:, tp.rank * n:(tp.rank + 1) * n] = y
    return tp.all_reduce(full)


class QEmbedding(nn.Module):
    """Quantized embedding table: rows gathered, then dequantized."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("q", q)  # int8 [V, D]
        self.register_buffer("scales", scales)  # f32 [V, D // 32]
        self.register_buffer("bias", bias)  # f32 [V, D // 32] or None

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = (self.q[tokens].float()
             * self.scales[tokens].float().repeat_interleave(QK, dim=-1))
        if self.bias is not None:
            x = x - self.bias[tokens].float().repeat_interleave(QK, dim=-1)
        return x


class LlamaLayer(nn.Module):
    """One decoder layer. Fused projections (wqkv, wgu) when the loader
    could concatenate them, else the separate ones. An MoE layer has a
    router (f32 [dim, E]) and three expert stacks in place of the dense
    FFN."""

    def __init__(self, attn_norm: torch.Tensor, ffn_norm: torch.Tensor, *,
                 wo: QLinear, w_down: QLinear | None = None,
                 wqkv: QLinear | None = None,
                 bqkv: torch.Tensor | None = None, wq: QLinear | None = None,
                 wk: QLinear | None = None, wv: QLinear | None = None,
                 bq: torch.Tensor | None = None,
                 bk: torch.Tensor | None = None,
                 bv: torch.Tensor | None = None, wgu: QLinear | None = None,
                 w_gate: QLinear | None = None, w_up: QLinear | None = None,
                 q_norm: torch.Tensor | None = None,
                 k_norm: torch.Tensor | None = None,
                 router: torch.Tensor | None = None,
                 w_gate_exps: QLinear | None = None,
                 w_up_exps: QLinear | None = None,
                 w_down_exps: QLinear | None = None):
        super().__init__()
        experts = (w_gate_exps, w_up_exps, w_down_exps)
        if router is not None:
            ffn_ok = (all(e is not None and e.n_slabs for e in experts)
                      and wgu is None and w_gate is None and w_down is None)
        else:
            ffn_ok = ((wgu is None) != (w_gate is None)
                      and w_down is not None)
        if (wqkv is None) == (wq is None) or not ffn_ok:
            raise ValueError("give either wqkv or wq/wk/wv, and either wgu "
                             "or w_gate/w_up with w_down, or a router with "
                             "the three expert stacks")
        for name, t in (("attn_norm", attn_norm), ("ffn_norm", ffn_norm),
                        ("bqkv", bqkv), ("bq", bq), ("bk", bk), ("bv", bv),
                        ("q_norm", q_norm), ("k_norm", k_norm),
                        ("router", router)):
            self.register_buffer(name, t)
        self.wqkv, self.wq, self.wk, self.wv = wqkv, wq, wk, wv
        self.wo, self.wgu, self.w_gate, self.w_up = wo, wgu, w_gate, w_up
        self.w_down = w_down
        self.w_gate_exps, self.w_up_exps, self.w_down_exps = experts

    @staticmethod
    def _lin(h: torch.Tensor, w: QLinear, b: torch.Tensor | None):
        y = qmatmul(h, w)
        return y if b is None else y + b

    def forward(self, x: torch.Tensor, llm: LLMConfig, kv: KVCache,
                layer: int, cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor, index: torch.Tensor,
                fuse: bool = False,
                deferred: DeferredKV | None = None,
                bits: torch.Tensor | None = None,
                attn_mask: torch.Tensor | None = None,
                norm_input: bool = True, tp=None, ep=None,
                sp=None) -> torch.Tensor:
        """x [S, Tq, dim] (the residual stream: bf16 in a model, f32 in
        an EAGLE head) -> the layer's output in x's dtype. norm_input
        False feeds x to the QKV projection without the attention norm
        (an EAGLE-1 head's first layer). tp: the TPComm of a sharded
        layer (wo and down all_reduced); ep: the expert-parallel TPComm
        of an MoE layer holding its rank's experts; sp: the sequence-
        parallel TPComm (kv a SeqShardCache)."""
        reduce = (lambda t: t) if tp is None else tp.all_reduce
        S, Tq, _ = x.shape
        H, Hkv, D = llm.n_heads, llm.n_kv_heads, llm.head_size
        eps = llm.norm_eps
        fused = (fuse and self.wqkv is not None and self.wgu is not None
                 and self.q_norm is None and self.router is None
                 and S * Tq <= FUSED_MAX_M)
        xf = x.reshape(S * Tq, -1)
        if fused:
            pro = (dict(norm=(xf, self.attn_norm)) if norm_input
                   else dict(x=xf))
            qkv = fused_linear(self.wqkv, bias=self.bqkv, eps=eps, **pro)
        else:
            h = (rms_norm(xf, self.attn_norm, eps) if norm_input
                 else xf).to(torch.bfloat16)
            if self.wqkv is not None:
                qkv = self._lin(h, self.wqkv, self.bqkv)
        if self.wqkv is not None:
            q = qkv[:, : H * D]
            k = qkv[:, H * D: (H + Hkv) * D]
            v = qkv[:, (H + Hkv) * D:]
        else:
            q = self._lin(h, self.wq, self.bq)
            k = self._lin(h, self.wk, self.bk)
            v = self._lin(h, self.wv, self.bv)
        q = q.reshape(S, Tq, H, D)
        k = k.reshape(S, Tq, Hkv, D)
        v = v.reshape(S, Tq, Hkv, D)
        if self.q_norm is not None:  # qwen3 QK-norm, before RoPE
            q = rms_norm(q, self.q_norm, eps)
            k = rms_norm(k, self.k_norm, eps)
        q = apply_rope(q, cos, sin, llm.rope.rope_type)
        k = apply_rope(k, cos, sin, llm.rope.rope_type)

        scale = 1.0 / math.sqrt(D)
        if deferred is not None:
            attn = deferred.attend(kv, layer, q, k, v, scale)
        else:
            kv.write(layer, k, v, index)
            attn = attention(kv, layer, q, positions, scale, bits, attn_mask,
                             sp)
        if fused:
            # attn_out stays f32 into the next norm and the residual sum,
            # as in the JAX fused chain
            attn_out = reduce(fused_linear(self.wo,
                                           x=attn.reshape(S * Tq, -1)))
            gu = fused_linear(self.wgu, norm=(xf, attn_out, self.ffn_norm),
                              eps=eps)
            if tp is None:
                xn = fused_linear(self.w_down, glu=gu, resids=(xf, attn_out))
            else:  # the epilogue's order: (r0 + r1) + y
                xn = ((xf.float() + attn_out)
                      + reduce(fused_linear(self.w_down, glu=gu)))
            return xn.reshape(S, Tq, -1).to(x.dtype)
        attn_out = reduce(qmatmul(attn.reshape(S * Tq, -1).to(torch.bfloat16),
                                  self.wo))
        x = x + attn_out.reshape(S, Tq, -1).to(x.dtype)

        h2 = rms_norm(x, self.ffn_norm, eps).to(torch.bfloat16)
        h2 = h2.reshape(S * Tq, -1)
        if self.router is not None:
            down = self.moe_ffn(h2, llm.n_experts_used, ep)
            if ep is not None:  # the ranks' disjoint experts
                down = ep.all_reduce(down)
            down = reduce(down)  # row-parallel expert down slabs
            return x + down.reshape(S, Tq, -1).to(x.dtype)
        if self.wgu is not None:
            gu = qmatmul(h2, self.wgu)
            f = gu.shape[-1] // 2
            gate, up = gu[:, :f], gu[:, f:]
        else:
            gate, up = qmatmul(h2, self.w_gate), qmatmul(h2, self.w_up)
        act = silu_hadamard(gate, up).to(torch.bfloat16)
        down = reduce(qmatmul(act, self.w_down))
        return x + down.reshape(S, Tq, -1).to(x.dtype)

    def route(self, h: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k experts of each row of h [N, dim]: (ids [N, k], weights
        f32 [N, k]), the softmax over all experts renormalized over the k
        chosen (floored at 1e-9)."""
        logits = h.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)
        return topi, topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    def _experts(self, h: torch.Tensor, mm) -> torch.Tensor:
        """silu(h @ gate) * (h @ up) @ down, each product through mm."""
        g = mm(h, self.w_gate_exps)
        u = mm(h, self.w_up_exps)
        return mm(silu_hadamard(g, u).to(torch.bfloat16), self.w_down_exps)

    def moe_ffn(self, h: torch.Tensor, k: int, ep=None) -> torch.Tensor:
        """The expert FFN of rows h [N, dim] (bf16) -> f32 [N, dim]; with
        ep, this rank's experts' share of it (rows routed elsewhere add
        zeros)."""
        n = h.shape[0]
        topi, topw = self.route(h, k)
        route, bm = moe_route(n)
        n_local = self.w_gate_exps.n_slabs
        e_off = 0
        if ep is not None:
            e_off = ep.rank * n_local
            if route == "single":
                route, bm = "grouped", GEMV_MAX_M
        if route == "single":
            # the k routed slabs only, as k one-row tiles; the outputs
            # summed in routing order
            ids = topi[0].to(torch.int32)
            y = self._experts(h.expand(k, -1),
                              lambda a, w: qmatmul_grouped(a, w, ids, 1))
            out = torch.zeros_like(y[:1])
            for j in range(k):
                out = out + y[j:j + 1] * topw[0, j]
            return out
        tok, w, tile_e = group_dispatch(topi, topw, n_local, e_off, bm)
        y = self._experts(h[tok.clamp(min=0).long()],
                          lambda a, e: qmatmul_grouped(a, e, tile_e, bm))
        return combine(y, tok, w, n, k)


class LlamaModel(nn.Module):
    """The embedding, the layers, the final norm and the lm_head; with
    lm_head_lr = (U, V), a factored head (speculative/draft_head.py) in
    place of the lm_head's."""

    def __init__(self, llm: LLMConfig, embed: QEmbedding,
                 layers: list[LlamaLayer], out_norm: torch.Tensor,
                 lm_head: QLinear,
                 lm_head_lr: tuple[QLinear, QLinear] | None = None):
        super().__init__()
        self.llm = llm
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.register_buffer("out_norm", out_norm)
        self.lm_head = lm_head
        self.lm_head_lr = None if lm_head_lr is None else nn.ModuleList(
            lm_head_lr)
        # a rank's shards: its TPComm (parallel/tp.py shard_params_tp),
        # under expert parallelism its ep TPComm, under sequence
        # parallelism its sp TPComm (the cache a SeqShardCache)
        self.tp = None
        self.ep = None
        self.sp = None

    def head(self, h: torch.Tensor, argmax: bool = False) -> torch.Tensor:
        """Final norm + lm_head (+ greedy argmax) on rows [M, dim]; a
        factored head runs norm -> U, then V (+ argmax). A vocab-sharded
        head gathers its logits, or reduces its argmax, over the ranks."""
        norm = dict(norm=(h, self.out_norm), eps=self.llm.norm_eps)
        if self.lm_head_lr is not None:
            u, v = self.lm_head_lr
            return fused_linear(v, x=fused_linear(u, **norm), argmax=argmax)
        return vocab_linear(self.lm_head, self.llm.vocab_size, self.tp,
                            argmax, **norm)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The input rows f32 [S, Tq, dim] of tokens: the table's, or a
        vocab-sharded table's rows summed over the ranks (each id on one
        rank)."""
        return vocab_rows(self.embed, tokens, self.llm.vocab_size, self.tp)

    @torch.no_grad()
    def forward(self, kv: KVCache, tokens: torch.Tensor,
                positions: torch.Tensor, *,
                active: torch.Tensor | None = None,
                logits_mode: str = "last", fuse_layers: bool = False,
                kv_update: str = "inline",
                cache_positions: torch.Tensor | None = None,
                intra_mask: torch.Tensor | None = None,
                key_positions: torch.Tensor | None = None,
                attn_mask: torch.Tensor | None = None,
                return_final_hidden: bool = False,
                return_hidden: bool = False,
                embeds: torch.Tensor | None = None):
        """One forward pass over a batch of slots; updates kv in place.

        kv: the dense KVCache or the paged PagedKVCache.
        tokens/positions: [S, Tq] (positions drive RoPE and the cache
        writes; -1 or >= max_seq are not written). For Tq > DECODE_MAX_TQ
        each slot's real positions must run contiguously from
        positions[:, 0], padding (-1) at the end — a prefill chunk.
        active: [S] bool rows whose pos advances (default all).
        Token-tree speculation (Tq <= DECODE_MAX_TQ; the JAX forward's
        cache_positions, intra_mask and vis_override):
          cache_positions [S, Tq]: where the K/V rows are written and
            marked, apart from the RoPE positions (node i of a tree at
            c + i, its rope position c + depth(i));
          intra_mask [Tq, J] bool: which keys each row sees besides the
            committed mask (a verify's ancestor rows; default causal);
          key_positions [S, J]: where those keys lie (default
            cache_positions: a verify); a draft level passes all of the
            tree's nodes and its own rows' ancestors-or-self;
          attn_mask [S, T] bool: the committed visibility to attend with
            (default kv.mask; a draft level passes the mask as it was at
            the tree's start, since each level marks its own nodes).
        logits_mode: "last" -> f32 [S, vocab] for the final position;
          "all" -> [S, Tq, vocab]; "argmax" -> greedy tokens int32 [S];
          "argmax_all" -> greedy tokens int32 [S, Tq]; "none" -> [S, 0].
        fuse_layers: the fused decode-layer chain for batches of at most
          16 rows (layers with fused QKV and gate|up, no QK-norm, dense).
        kv_update: "inline" (write each layer's K/V, then attend) or
          "deferred" (the paged pool at Tq <= 16 only: attend to the new
          K/V in flight, commit all layers after the loop).
        return_final_hidden: return (logits, hidden) with hidden the last
          layer's pre-norm output [S, Tq, dim] bf16, the feature an EAGLE
          head autoregresses over (speculative/eagle.py).
        return_hidden: return (logits, hidden) with hidden the residual
          stream after each layer [L, S, Tq, dim] bf16 (the per-layer
          dumps of tools/dump_activations.py); not with kv_update
          "deferred". Off, the forward does no work for it.
        embeds: [S, Tq, dim] input rows in place of the embedding lookup
          (rounded to bf16): a multimodal prefill's text embeddings with
          image features at the image-context positions
          (models/internvl.py).
        """
        llm = self.llm
        S, Tq = tokens.shape
        cpos = positions if cache_positions is None else cache_positions
        tree = (intra_mask is not None or key_positions is not None
                or attn_mask is not None)
        if tree and (Tq > DECODE_MAX_TQ or intra_mask is None):
            raise ValueError("a token tree's options take an intra_mask "
                             f"and at most {DECODE_MAX_TQ} query rows")
        deferred = None
        if kv_update == "deferred":
            if return_hidden:
                raise ValueError("return_hidden takes kv_update='inline'")
            if (not isinstance(kv, PagedKVCache) or Tq > DECODE_MAX_TQ
                    or key_positions is not None or attn_mask is not None):
                raise ValueError("kv_update='deferred' takes the paged pool, "
                                 f"at most {DECODE_MAX_TQ} query rows and "
                                 "no key_positions or attn_mask")
            deferred = DeferredKV(kv, cpos, intra_mask)
        elif kv_update != "inline":
            raise ValueError(f"kv_update {kv_update!r}")
        x = (self.embed_tokens(tokens) if embeds is None
             else embeds).to(torch.bfloat16)
        cos, sin = rope_cos_sin(positions, llm.rope, llm.head_size)
        keys = cpos if key_positions is None else key_positions
        keys32 = keys.to(torch.int32)
        bits = None if intra_mask is None else pack_intra(intra_mask)
        index = kv.write_index(cpos)
        hidden = [] if return_hidden else None
        for i, layer in enumerate(self.layers):
            x = layer(x, llm, kv, i, cos, sin, keys32, index,
                      fuse=fuse_layers, deferred=deferred, bits=bits,
                      attn_mask=attn_mask, tp=self.tp, ep=self.ep,
                      sp=self.sp)
            if hidden is not None:
                hidden.append(x)
        if deferred is not None:
            kv.commit(deferred.blocks, index)
        kv.advance(cpos, active=active)

        logits = self.logits(x, logits_mode)
        if hidden is not None:
            return logits, torch.stack(hidden)
        return (logits, x) if return_final_hidden else logits

    def logits(self, x: torch.Tensor, logits_mode: str) -> torch.Tensor:
        """The head over the final hidden x [S, Tq, dim] in a forward's
        logits_mode."""
        S, Tq, _ = x.shape
        if logits_mode == "none":
            return torch.zeros(S, 0, dtype=torch.float32, device=x.device)
        if logits_mode == "argmax":
            return self.head(x[:, -1, :], argmax=True)
        if logits_mode == "argmax_all":
            return self.head(x.reshape(S * Tq, -1), argmax=True).reshape(S, Tq)
        if logits_mode == "last":
            return self.head(x[:, -1, :])
        if logits_mode == "all":
            return self.head(x.reshape(S * Tq, -1)).reshape(S, Tq, -1)
        raise ValueError(f"logits_mode {logits_mode!r}")
