"""EAGLE speculation: a feature-level draft head.

EAGLE (Li et al., 2024) drafts with ONE decoder layer that autoregresses
over the target's last-layer hidden states ("features"): the head's
input at position j is fc([embed(t_j); f_{j-1}]), the token at j
concatenated with the target feature that produced it, and its output
approximates f_j, decoded through the target's own lm_head. A draft
costs about 1/L of a target step.

The head (EagleHead) runs on its own int8 cache: the fc input through
the concat2 prologue of csrc/fused_linear.cu (ops/fused.py), the layers
on a f32 residual stream (the fused decode-layer chain at <= 16 rows,
the unfused qmatmul + flash-prefill route for prefill chunks), and the
head's logits through the fused linear (+ the argmax of a greedy
draft).

Per speculative step, for every slot at once (eagle_spec_scan):
  1. draft: k head forwards (Tq = 1), each fed the head's own predicted
     feature;
  2. verify: one target forward over [root, d0 .. d_{k-1}] that also
     returns the true features (LlamaModel.forward(...,
     return_final_hidden=True));
  3. accept: the greedy longest prefix, or min(1, p/q) with residual
     resampling (speculative sampling, as speculative/chain.py);
  4. commit: the target rolls back its rejected entries; the head drops
     all k drafted entries and re-prefills the accepted tokens paired
     with the TRUE features (one Tq = k + 1 head forward), so drafted
     feature noise never stays in its cache.
eagle_tree_spec_scan drafts a TreeTemplate instead (EAGLE-2 style): one
head forward per level over the template (siblings take the head's
rank-r tokens), written at c + node and kept masked (KVCache.advance's
visible=False), each row attending to the committed prefix and its
ancestors through flash-decode's tree mode; one verify over the tree
with the ancestor mask; the acceptance walk of speculative/
device_tree.py; the target compacts the accepted path, the head drops
its N - |last level| drafted entries and re-prefills the path.

Over a rank group (parallel/tp.py) the head is sharded like a target
layer (its layers' QKV and gate|up over their columns, wo and down over
their rows; the fc and the norms replicated; the embedding and lm_head
the target's own shards) and its cache over kv heads: EagleHead.tp is a
rank's TPComm, and rank 0's TPEagleHead runs eagle_forward on every rank
(the JAX prepare_eagle_for_tp, eagle_param_specs, tp_eagle_*).

The JAX package runs the steps inside one lax.scan (its window-KV
routes for both caches are not ported: the port commits every step).
Here a step is one CUDA graph replayed once per step
(engine/graphs.py): the scans' greedy steps, and the scheduler's steps
over its buffers (eagle_sample_body), whose draws come from per-slot
Philox streams through csrc/sample.cu; eagle_spec_scan and
eagle_tree_spec_scan with sample= run the same steps eagerly.
"""

from __future__ import annotations

import weakref

import torch
from torch import nn

from ..core.config import LLMConfig, ModelConfig
from ..engine.graphs import graphs_of, steps_capacity
from ..kv.cache import KVCache
from ..models.llama import (DECODE_MAX_TQ, LlamaLayer, LlamaModel,
                            QEmbedding, vocab_linear, vocab_rows)
from ..ops.elementwise import rope_cos_sin
from ..ops.flash_decode import pack_intra
from ..ops.fused import fused_linear
from ..ops.qmatmul import QLinear, qmatmul
from ..sampling.sampler import (DrawState, categorical_from_dist,
                                sample_dist_batched, uniform_draws)
from .chain import ChainSpecEngine, _verify_update
from .device_tree import (TreeTemplate, _Consts, _consts_of, _greedy_walk,
                          _gumbel, _wor_accept_walk)

__all__ = ["EagleHead", "eagle_forward", "eagle_spec_scan",
           "eagle_tree_spec_scan", "eagle_sample_step",
           "eagle_tree_sample_step", "eagle_sample_body",
           "EagleChainEngine", "with_lm_head_lr", "replica_head"]


class EagleHead(nn.Module):
    """Draft-head weights (the JAX EagleParams) and the head's geometry.

    fc: [2 * dim -> dim] feature fusion, input order [embedding;
    feature]; fc_bias f32 [dim] or None. layers: the decoder layers
    (usually one). embed / lm_head: usually the target's own objects (a
    head GGUF may carry its own). out_norm: an RMS-norm weight before
    the lm_head, or None (EAGLE-1: the raw feature). input_norm: layer 0
    applies its attn_norm (EAGLE-1 heads have none: False). lm_head_lr:
    a factored draft head (U, V) (speculative/draft_head.py) read in
    place of the lm_head."""

    def __init__(self, llm: LLMConfig, fc: QLinear,
                 fc_bias: torch.Tensor | None, layers: list[LlamaLayer],
                 embed: QEmbedding, lm_head: QLinear,
                 out_norm: torch.Tensor | None = None,
                 input_norm: bool = False,
                 lm_head_lr: tuple[QLinear, QLinear] | None = None):
        super().__init__()
        if len(layers) != llm.n_layers:
            raise ValueError(f"{len(layers)} layers for a head of "
                             f"{llm.n_layers}")
        self.llm = llm
        self.fc = fc
        self.register_buffer("fc_bias", fc_bias)
        self.layers = nn.ModuleList(layers)
        self.embed = embed
        self.lm_head = lm_head
        self.register_buffer("out_norm", out_norm)
        self.input_norm = bool(input_norm)
        self.lm_head_lr = None if lm_head_lr is None else nn.ModuleList(
            lm_head_lr)
        # a rank's shards: its TPComm (parallel/tp.py shard_eagle_tp)
        self.tp = None

    @property
    def head_width(self) -> int:
        """Columns of the head's logits."""
        if self.lm_head_lr is not None:
            return self.lm_head_lr[1].out_features
        return self.lm_head.out_features

    def head(self, h: torch.Tensor, argmax: bool = False) -> torch.Tensor:
        """Rows h [M, dim] f32 -> logits f32 [M, width] (or greedy tokens
        int32 [M]): out_norm (or none), then the lm_head or U, V, each
        one fused linear."""
        first = (dict(x=h) if self.out_norm is None
                 else dict(norm=(h, self.out_norm)))
        eps = self.llm.norm_eps
        if self.lm_head_lr is not None:
            u, v = self.lm_head_lr
            return fused_linear(v, x=fused_linear(u, eps=eps, **first),
                                argmax=argmax)
        return vocab_linear(self.lm_head, self.llm.vocab_size, self.tp,
                            argmax, eps=eps, **first)


def with_lm_head_lr(head: EagleHead, lm_head_lr: tuple) -> EagleHead:
    """A view of `head` whose drafting logits read the factored (U, V)
    (no weight is copied)."""
    view = EagleHead(head.llm, head.fc, head.fc_bias, list(head.layers),
                     head.embed, head.lm_head, head.out_norm,
                     head.input_norm, lm_head_lr)
    view.tp = head.tp
    return view


@torch.no_grad()
def eagle_forward(head: EagleHead, kv: KVCache, tokens: torch.Tensor,
                  features: torch.Tensor, positions: torch.Tensor, *,
                  active: torch.Tensor | None = None,
                  cache_positions: torch.Tensor | None = None,
                  intra_mask: torch.Tensor | None = None,
                  key_positions: torch.Tensor | None = None,
                  visible: bool = True, logits_mode: str = "last",
                  fuse_layers: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One head forward over tokens [S, Tq] and their paired features
    [S, Tq, dim] (the feature at position j - 1 pairs with the token at
    j); updates the head's cache kv in place.

    positions drive RoPE (and, without cache_positions, the writes); -1
    lanes are not written. A token tree's draft level passes
    cache_positions (node i at c + i), intra_mask [Tq, J] and
    key_positions [S, J] (its rows' ancestors-or-self among the tree's
    nodes, through flash-decode's tree mode) and visible=False: its
    entries stay masked after the forward, so later levels see the
    committed prefix only. logits_mode: "last", "all", "argmax" (int32
    greedy tokens of the last row) or "none". fuse_layers: the fc and
    decode-sized layers through the fused linear (the unfused
    composition otherwise).

    Returns (logits, feature_out [S, Tq, dim] f32): the head's predicted
    next features, fed back in autoregressive drafting. A rank group's
    head (parallel/tp.py TPEagleHead) runs this on every rank's shards."""
    if getattr(head, "remote", False):
        return head.forward(kv, tokens, features, positions, active=active,
                            cache_positions=cache_positions,
                            intra_mask=intra_mask,
                            key_positions=key_positions, visible=visible,
                            logits_mode=logits_mode, fuse_layers=fuse_layers)
    llm = head.llm
    S, Tq = tokens.shape
    M = S * Tq
    cpos = positions if cache_positions is None else cache_positions
    if ((intra_mask is not None or key_positions is not None)
            and (Tq > DECODE_MAX_TQ or intra_mask is None)):
        raise ValueError("a token tree's options take an intra_mask and at "
                         f"most {DECODE_MAX_TQ} query rows")
    emb = vocab_rows(head.embed, tokens, llm.vocab_size, head.tp).reshape(
        M, -1)
    feat = features.reshape(M, -1)
    if fuse_layers:
        x = fused_linear(head.fc, parts=(emb, feat), bias=head.fc_bias)
    else:
        x = qmatmul(torch.cat([emb.to(torch.bfloat16),
                               feat.to(torch.bfloat16)], dim=-1), head.fc)
        if head.fc_bias is not None:
            x = x + head.fc_bias
    x = x.reshape(S, Tq, -1).float()
    cos, sin = rope_cos_sin(positions, llm.rope, llm.head_size)
    keys = (cpos if key_positions is None else key_positions).to(torch.int32)
    bits = None if intra_mask is None else pack_intra(intra_mask)
    index = kv.write_index(cpos)
    for i, layer in enumerate(head.layers):
        x = layer(x, llm, kv, i, cos, sin, keys, index, fuse=fuse_layers,
                  bits=bits, norm_input=head.input_norm or i > 0, tp=head.tp)
    vis = None if visible else torch.zeros_like(cpos, dtype=torch.bool)
    kv.advance(cpos, active=active, visible=vis)
    if logits_mode == "none":
        logits = torch.zeros(S, 0, dtype=torch.float32, device=x.device)
    elif logits_mode == "argmax":
        logits = head.head(x[:, -1], argmax=True)
    elif logits_mode == "last":
        logits = head.head(x[:, -1])
    elif logits_mode == "all":
        logits = head.head(x.reshape(M, -1)).reshape(S, Tq, -1)
    else:
        raise ValueError(f"logits_mode {logits_mode!r}")
    return logits, x


def replica_head(target: LlamaModel) -> EagleHead:
    """The exact-replica head of a 1-layer target: fc = [I; 0] in Q8_0
    feeds the token's embedding alone, and the head's layer, final norm,
    embedding and lm_head are the target's own objects, so every draft
    is the target's next token and a greedy step accepts all of them (a
    check of the speculation plumbing, on one device or a rank's
    shards)."""
    if target.llm.n_layers != 1:
        raise ValueError("the exact-replica head drafts a 1-layer target")
    from ..core.gguf import GGMLType

    dim = target.llm.dim
    fc = torch.cat([torch.eye(dim), torch.zeros(dim, dim)])  # [2 dim, dim]
    dev = target.out_norm.device
    return EagleHead(target.llm, QLinear.from_float(
        fc.numpy(), GGMLType.Q8_0, device=dev), None, [target.layers[0]],
        target.embed, target.lm_head, target.out_norm, input_norm=True)


# -- the chain ----------------------------------------------------------------


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [S, n, dim] at rows idx [S] -> [S, dim]."""
    return t.gather(1, idx[:, None, None].expand(-1, 1, t.shape[-1]))[:, 0]


def _reprefill(head: EagleHead, e_kv: KVCache, fed: torch.Tensor,
               root_feat: torch.Tensor, feats: torch.Tensor,
               c: torch.Tensor, n_acc: torch.Tensor,
               active: torch.Tensor) -> None:
    """Drop every entry the head drafted past c and write the accepted
    chain fed [S, D + 1] (lanes past n_acc dropped) at c, c + 1, ...: its
    token i paired with the TRUE feature of the token before it
    (root_feat [S, dim] for i = 0, feats [S, D, dim] after)."""
    e_kv.rollback(e_kv.pos.long() - c, active=active)
    lanes = torch.arange(fed.shape[1], device=fed.device)
    live = (lanes[None, :] <= n_acc[:, None]) & active[:, None]
    pos = torch.where(live, c[:, None] + lanes[None, :], -1)
    eagle_forward(head, e_kv, fed, torch.cat([root_feat[:, None], feats],
                                             dim=1),
                  pos, active=active, logits_mode="none")


def _draft_chain(head: EagleHead, e_kv: KVCache, root: torch.Tensor,
                 root_feat: torch.Tensor, k: int, active: torch.Tensor,
                 logits_mode: str, pick) -> list[torch.Tensor]:
    """k head forwards from the root, each fed the head's predicted
    feature; pick(logits) -> the draft [S]. Returns [root, d0 ..
    d_{k-1}]."""
    fed, tok, feat = [root], root, root_feat
    for _ in range(k):
        pos = torch.where(active, e_kv.pos.long(), -1)[:, None]
        logits, f = eagle_forward(head, e_kv, tok[:, None], feat[:, None],
                                  pos, active=active,
                                  logits_mode=logits_mode)
        tok = pick(logits)
        feat = f[:, -1]
        fed.append(tok)
    return fed


def _step_bufs(dev: torch.device, S: int, dim: int, width: int,
               cap: int) -> dict:
    """A greedy step's static buffers: root [S], feat [S, dim] and active
    [S] in; tokens [cap, S, width], counts [cap, S] and the step counter
    out."""
    z = lambda *shape, dtype=torch.int64: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    return dict(root=z(S), feat=z(S, dim, dtype=torch.float32),
                active=torch.ones(S, dtype=torch.bool, device=dev),
                tokens=z(cap, S, width), counts=z(cap, S), step=z(1))


def _greedy_chain_step(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                       e_kv: KVCache, S: int, k: int, cap: int) -> tuple:
    """The body of one greedy EAGLE chain step over every slot and its
    buffers: root [S], feat [S, dim] and active [S] in; the step's tokens
    [S, k + 1] and counts [S] to row `step` of tokens [cap, S, k + 1] and
    counts [cap, S]; the next root and its feature back into root and
    feat."""
    dev = t_kv.device
    bufs = _step_bufs(dev, S, target.llm.dim, k + 1, cap)
    lanes = torch.arange(k + 1, device=dev)
    update = _verify_update(t_kv)
    V = target.llm.vocab_size
    # the fused argmax head when the head's width is the vocab
    fused = head.head_width == V
    refs = [weakref.ref(o) for o in (target, head, t_kv, e_kv)]
    b = bufs

    def body():
        tgt, hd, tkv, ekv = (r() for r in refs)
        root, feat, active = b["root"], b["feat"], b["active"]
        act = active[:, None]
        c = tkv.pos.long()
        fed = torch.stack(_draft_chain(
            hd, ekv, root, feat, k, active, "argmax" if fused else "last",
            lambda lg: (lg if fused else lg[:, :V].argmax(dim=-1)).long()),
            dim=1)
        sampled, feats = tgt(tkv, fed, torch.where(act, c[:, None] + lanes,
                                                   -1),
                             active=active, logits_mode="argmax_all",
                             kv_update=update, return_final_hidden=True)
        sampled, feats = sampled.long(), feats.float()
        match = (sampled[:, :k] == fed[:, 1:]).long()
        n_acc = match.cumprod(dim=1).sum(dim=1)  # [S] in [0, k]
        tkv.rollback(k - n_acc, active=active)
        _reprefill(hd, ekv, fed, feat, feats[:, :k], c, n_acc, active)
        root.copy_(torch.where(active, sampled.gather(1, n_acc[:, None])[:, 0],
                               root))
        feat.copy_(torch.where(act, _gather_rows(feats, n_acc), feat))
        live = (lanes[None, :] <= n_acc[:, None]) & act
        b["tokens"].index_copy_(0, b["step"],
                                torch.where(live, sampled, -1)[None])
        b["counts"].index_copy_(0, b["step"],
                                torch.where(active, n_acc + 1, 0)[None])
        b["step"].add_(1)

    return body, bufs


def eagle_sample_step(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                      e_kv: KVCache, root: torch.Tensor,
                      root_feat: torch.Tensor, k: int, active: torch.Tensor,
                      draws: DrawState | None,
                      temp: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> tuple:
    """One step of EAGLE speculative sampling over a batch of slots with
    their sampler settings ([S] each) and streams (draws; None: every
    slot at temperature <= 0, greedy, nothing drawn): the head
    samples each draft from its own distribution q, a draft is accepted
    with probability min(1, p/q), and the first rejection resamples from
    the residual (p - q)^+. Returns (emitted [S, k + 1] (-1 past each
    count, everywhere for inactive slots), counts [S], next root [S], its
    feature [S, dim])."""
    S, dev = root.shape[0], root.device
    V = target.llm.vocab_size
    lanes = torch.arange(k + 1, device=dev)
    act = active[:, None]
    rep = lambda a: a.repeat_interleave(k + 1)  # noqa: E731
    c = t_kv.pos.long()
    qs = []

    def pick(logits):
        q = sample_dist_batched(logits[:, :V], temp, top_k, top_p,
                                vocab_size=V)
        qs.append(q)
        return categorical_from_dist(q, draws)

    fed = torch.stack(_draft_chain(head, e_kv, root, root_feat, k, active,
                                   "last", pick), dim=1)
    q_d = torch.stack(qs, dim=1)  # [S, k, V]; q_j drew d_j
    logits, feats = target(t_kv, fed, torch.where(act, c[:, None] + lanes,
                                                  -1),
                           active=active, logits_mode="all",
                           kv_update=_verify_update(t_kv),
                           return_final_hidden=True)
    feats = feats.float()
    p = sample_dist_batched(
        logits.reshape(S * (k + 1), -1)[:, :V], rep(temp), rep(top_k),
        rep(top_p), vocab_size=V).reshape(S, k + 1, V)
    d = fed[:, 1:]
    p_at_d = p[:, :k].gather(2, d[..., None])[..., 0]
    q_at_d = q_d.gather(2, d[..., None])[..., 0]
    u = uniform_draws(draws, S, k, dev)
    n_acc = (u * q_at_d < p_at_d).long().cumprod(dim=1).sum(dim=1)
    # the residual (p - q)^+ at the rejected position, p itself at the
    # bonus position (n_acc == k)
    sel = n_acc[:, None, None].expand(S, 1, V)
    p_sel = p.gather(1, sel)[:, 0]
    q_sel = torch.cat([q_d, torch.zeros(S, 1, V, device=dev)],
                      dim=1).gather(1, sel)[:, 0]
    residual = torch.clamp(p_sel - q_sel, min=0.0)
    rsum = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(rsum > 1e-12,
                           residual / torch.clamp(rsum, min=1e-30), p_sel)
    new_root = torch.where(active, categorical_from_dist(residual, draws),
                           root)
    emit = torch.where(lanes[None, :] < n_acc[:, None],
                       torch.cat([d, torch.zeros_like(d[:, :1])], dim=1),
                       torch.where(lanes[None, :] == n_acc[:, None],
                                   new_root[:, None], -1))
    t_kv.rollback(k - n_acc, active=active)
    _reprefill(head, e_kv, fed, root_feat, feats[:, :k], c, n_acc,
               active)
    new_feat = torch.where(act, _gather_rows(feats, n_acc), root_feat)
    return (torch.where(act, emit, -1), torch.where(active, n_acc + 1, 0),
            new_root, new_feat)


def eagle_sample_body(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                      e_kv: KVCache, bufs: dict, k: int,
                      template: TreeTemplate | None, wor: bool,
                      draws: DrawState | None):
    """The body of one eagle_sample_step (a chain of k), or with template
    one eagle_tree_sample_step, over the scheduler's buffers, replayed as
    one CUDA graph. Reads bufs root, feat, active, temp, top_k and top_p;
    writes the step's emitted and counts to row `step` of bufs
    spec_emitted [H, S, width] and spec_counts [H, S], the next root and
    its feature to bufs root and feat. Its draws come from `draws` (None:
    every slot greedy, nothing drawn)."""
    b = bufs
    step = b["step"]

    def body():
        args = (b["root"], b["feat"])
        sets = (b["active"], draws, b["temp"], b["top_k"], b["top_p"])
        if template is None:
            emit, count, root, feat = eagle_sample_step(
                target, head, t_kv, e_kv, *args, k, *sets)
        else:
            emit, count, root, feat = eagle_tree_sample_step(
                target, head, t_kv, e_kv, template, *args, *sets, wor)
        b["spec_emitted"].index_copy_(0, step, emit[None])
        b["spec_counts"].index_copy_(0, step, count[None])
        b["root"].copy_(root)
        b["feat"].copy_(feat)
        step.add_(1)

    return body


def _run_steps(g, root, root_feat, active, n_steps: int) -> tuple:
    b = g.bufs
    b["root"].copy_(root)
    b["feat"].copy_(root_feat)
    b["active"].copy_(active)
    b["step"].zero_()
    for _ in range(n_steps):
        g()
    return (b["tokens"][:n_steps].clone(), b["counts"][:n_steps].clone(),
            b["root"].clone(), b["feat"].clone())


@torch.no_grad()
def eagle_spec_scan(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                    e_kv: KVCache, root: torch.Tensor,
                    root_feat: torch.Tensor, n_steps: int, k: int,
                    active: torch.Tensor | None = None,
                    draws: DrawState | None = None,
                    temp: torch.Tensor | None = None,
                    top_k: torch.Tensor | None = None,
                    top_p: torch.Tensor | None = None,
                    sample: bool = False) -> tuple:
    """n_steps EAGLE chain steps for every slot of the caches.

    root: int64 [S], each slot's last committed token (at position c,
    not yet in the target's cache); root_feat: f32 [S, dim], the target
    feature at c - 1 (the one whose logits gave the root); active: bool
    [S] (default all). sample False: greedy drafts and acceptance, each
    step a replay of one CUDA graph (kept with t_kv); True: speculative
    sampling (eagle_sample_step; draws the slots' streams, temp, top_k
    and top_p [S] their settings), eager. Returns (emitted [n_steps, S, k + 1],
    counts [n_steps, S], root [S], root_feat [S, dim]) on the device:
    step i emitted emitted[i, s, :counts[i, s]]."""
    S, dev = root.shape[0], root.device
    if active is None:
        active = torch.ones(S, dtype=torch.bool, device=dev)
    if sample:
        emitted, counts = [], []
        for _ in range(n_steps):
            emit, count, root, root_feat = eagle_sample_step(
                target, head, t_kv, e_kv, root, root_feat, k, active,
                draws, temp, top_k, top_p)
            emitted.append(emit)
            counts.append(count)
        return torch.stack(emitted), torch.stack(counts), root, root_feat
    cap = steps_capacity(n_steps)
    g = graphs_of(t_kv).step(
        ("eagle", S, k, cap),
        lambda: _greedy_chain_step(target, head, t_kv, e_kv, S, k, cap),
        deps=(target, head, e_kv))
    return _run_steps(g, root, root_feat, active, n_steps)


# -- the tree -----------------------------------------------------------------


def _draft_levels(head: EagleHead, e_kv: KVCache, k: _Consts,
                  tokens: torch.Tensor, feats_in: torch.Tensor,
                  c: torch.Tensor, active: torch.Tensor, choose) -> None:
    """The head's forward over each level d < D (the deepest level's nodes
    have no children, so their entries are never needed): node i at c +
    i, RoPE c + depth(i), fed its parent's predicted feature; its
    entries stay masked, so a row sees the committed prefix and, through
    the tree mode, its ancestors-or-self. choose(d, logits [S, ln, V])
    gives the candidates [S, ln, w] whose assigned ranks become the next
    level's tokens, written with the rows' features into tokens [S, N]
    and feats_in [S, N, dim] in place."""
    tpl = k.tpl
    act = active[:, None]
    keys = torch.where(act, c[:, None] + k.nodes[None, :], -1)
    for d in range(tpl.max_depth):
        lev = k.levels[d]
        logits, f = eagle_forward(
            head, e_kv, tokens[:, lev], feats_in[:, lev],
            torch.where(act, c[:, None] + k.depths[lev], -1), active=active,
            cache_positions=torch.where(act, c[:, None] + lev, -1),
            intra_mask=k.level_anc[d], key_positions=keys, visible=False,
            logits_mode="all")
        rows, children, ranks = k.assign[d]
        tokens[:, children] = choose(d, logits)[:, rows, ranks]
        feats_in[:, children] = f[:, rows]


def _tree_commit(head: EagleHead, t_kv: KVCache, e_kv: KVCache,
                 k: _Consts, tokens: torch.Tensor, chain_m: torch.Tensor,
                 feats_true: torch.Tensor, root_feat: torch.Tensor,
                 c: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The target compacts the accepted path chain_m [S, D + 1] (node ids,
    -1 past its end) to c, c + 1, ...; the head drops its drafted
    entries and re-prefills the path on the true features. Returns the
    committed counts [S] (0 for inactive slots)."""
    S = c.shape[0]
    n_acc = (chain_m[:, 1:] >= 0).sum(dim=1)
    n_commit = torch.where(active, n_acc + 1, 0)
    t_kv.rollback(t_kv.pos.long() - c, active=active)
    t_kv.commit_tokens(torch.arange(S, device=c.device),
                       torch.where(chain_m >= 0, c[:, None] + chain_m, -1),
                       n_commit)
    path = chain_m.clamp(min=0)
    fd = feats_true.shape[-1]
    feats_pred = feats_true.gather(
        1, path[:, :-1, None].expand(-1, -1, fd))  # predecessors of 1..D
    _reprefill(head, e_kv, tokens.gather(1, path), root_feat, feats_pred,
               c, n_acc, active)
    return n_commit


def _tree_buffers(k: _Consts, root: torch.Tensor, root_feat: torch.Tensor):
    S, N = root.shape[0], k.tpl.n_nodes
    tokens = torch.zeros(S, N, dtype=torch.int64, device=root.device)
    tokens[:, 0] = root
    feats_in = torch.zeros(S, N, root_feat.shape[-1], device=root.device)
    feats_in[:, 0] = root_feat
    return tokens, feats_in


def _greedy_tree_step(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                      e_kv: KVCache, tpl: TreeTemplate, S: int, cap: int
                      ) -> tuple:
    """The body of one greedy EAGLE tree step over every slot and its
    buffers (those of _greedy_chain_step, tokens [cap, S, D + 1])."""
    dev = t_kv.device
    k = _consts_of(tpl, dev)
    D = tpl.max_depth
    V = target.llm.vocab_size
    bufs = _step_bufs(dev, S, target.llm.dim, D + 1, cap)
    refs = [weakref.ref(o) for o in (target, head, t_kv, e_kv)]
    b = bufs

    def body():
        tgt, hd, tkv, ekv = (r() for r in refs)
        root, feat, active = b["root"], b["feat"], b["active"]
        act = active[:, None]
        c = tkv.pos.long()
        tokens, feats_in = _tree_buffers(k, root, feat)
        _draft_levels(hd, ekv, k, tokens, feats_in, c, active,
                      lambda d, lg: torch.topk(
                          lg[:, :, :V], tpl.level_topk[d], dim=-1).indices)
        sampled, feats = tgt(
            tkv, tokens, torch.where(act, c[:, None] + k.depths, -1),
            active=active,
            cache_positions=torch.where(act, c[:, None] + k.nodes, -1),
            intra_mask=k.anc, logits_mode="argmax_all",
            return_final_hidden=True)
        sampled, feats = sampled.long(), feats.float()
        chain_m = _greedy_walk(k, tokens, sampled)
        emit = torch.where((chain_m >= 0) & act,
                           sampled.gather(1, chain_m.clamp(min=0)), -1)
        cur = chain_m.clamp(min=0).amax(dim=1)  # the path's last node
        count = _tree_commit(hd, tkv, ekv, k, tokens, chain_m, feats, feat,
                             c, active)
        root.copy_(torch.where(active, sampled.gather(1, cur[:, None])[:, 0],
                               root))
        feat.copy_(torch.where(act, _gather_rows(feats, cur), feat))
        b["tokens"].index_copy_(0, b["step"], emit[None])
        b["counts"].index_copy_(0, b["step"], count[None])
        b["step"].add_(1)

    return body, bufs


def eagle_tree_sample_step(target: LlamaModel, head: EagleHead,
                           t_kv: KVCache, e_kv: KVCache, tpl: TreeTemplate,
                           root: torch.Tensor, root_feat: torch.Tensor,
                           active: torch.Tensor, draws: DrawState | None,
                           temp: torch.Tensor, top_k: torch.Tensor,
                           top_p: torch.Tensor, wor: bool = False) -> tuple:
    """One EAGLE tree step over a batch of slots with their sampler
    settings ([S] each) and streams (draws; None: every slot at
    temperature <= 0). By default the head's top-k children, a child accepted when its
    token equals the target's sample after its parent; with wor, children
    drawn without replacement from the head's distribution and
    recursive-rejection acceptance. Returns (emitted [S, D + 1], counts
    [S], next root [S], its feature [S, dim])."""
    S, dev = root.shape[0], root.device
    k = _consts_of(tpl, dev)
    N, V = tpl.n_nodes, target.llm.vocab_size
    act = active[:, None]
    c = t_kv.pos.long()
    tokens, feats_in = _tree_buffers(k, root, root_feat)
    q_dists = torch.zeros(S, N, V, device=dev) if wor else None

    def dists(logits, n):
        rep = lambda a: a.repeat_interleave(n)  # noqa: E731
        return sample_dist_batched(
            logits.reshape(S * n, -1)[:, :V], rep(temp), rep(top_k),
            rep(top_p), vocab_size=V).reshape(S, n, V)

    def choose(d, logits):
        w = tpl.level_topk[d]
        if not wor:
            return torch.topk(logits[:, :, :V], w, dim=-1).indices
        # Gumbel top-k of the head's distribution q: draws without
        # replacement in rank order, what the acceptance assumes
        lev = k.levels[d]
        q_rows = dists(logits, len(lev))
        q_dists[:, lev] = q_rows
        g = _gumbel(draws, S, len(lev), V, dev)
        scores = torch.where(q_rows > 0, torch.log(q_rows) + g,
                             float("-inf"))
        return torch.topk(scores, w, dim=-1).indices

    _draft_levels(head, e_kv, k, tokens, feats_in, c, active, choose)
    logits, feats = target(
        t_kv, tokens, torch.where(act, c[:, None] + k.depths, -1),
        active=active,
        cache_positions=torch.where(act, c[:, None] + k.nodes, -1),
        intra_mask=k.anc, logits_mode="all", return_final_hidden=True)
    feats = feats.float()
    p = dists(logits, N)
    if wor:
        chain_m, final_tok = _wor_accept_walk(tokens, q_dists, p, k, active,
                                              draws, root)
        acc_toks = torch.where(chain_m[:, 1:] >= 0,
                               tokens.gather(1, chain_m[:, 1:].clamp(min=0)),
                               -1)
        emit = torch.cat([acc_toks, torch.full_like(acc_toks[:, :1], -1)],
                         dim=1)
        n_acc = (chain_m[:, 1:] >= 0).sum(dim=1)
        lane = torch.arange(tpl.max_depth + 1, device=dev)[None, :]
        emit = torch.where(lane == n_acc[:, None], final_tok[:, None], emit)
        new_root = torch.where(active, final_tok, root)
    else:
        sampled = categorical_from_dist(p.reshape(S * N, V),
                                        draws).reshape(S, N)
        chain_m = _greedy_walk(k, tokens, sampled)
        emit = torch.where(chain_m >= 0,
                           sampled.gather(1, chain_m.clamp(min=0)), -1)
        cur = chain_m.clamp(min=0).amax(dim=1)
        new_root = torch.where(active,
                               sampled.gather(1, cur[:, None])[:, 0], root)
    # the next root was drawn at the path's last node: pair it with that
    # node's true feature
    stop = chain_m.clamp(min=0).amax(dim=1)
    count = _tree_commit(head, t_kv, e_kv, k, tokens, chain_m, feats,
                         root_feat, c, active)
    new_feat = torch.where(act, _gather_rows(feats, stop), root_feat)
    return torch.where(act, emit, -1), count, new_root, new_feat


@torch.no_grad()
def eagle_tree_spec_scan(target: LlamaModel, head: EagleHead, t_kv: KVCache,
                         e_kv: KVCache, root: torch.Tensor,
                         root_feat: torch.Tensor, n_steps: int,
                         template: TreeTemplate,
                         active: torch.Tensor | None = None,
                         draws: DrawState | None = None,
                         temp: torch.Tensor | None = None,
                         top_k: torch.Tensor | None = None,
                         top_p: torch.Tensor | None = None,
                         sample=False) -> tuple:
    """n_steps EAGLE tree steps (EAGLE-2 style) for every slot of the
    caches; arguments and outputs as eagle_spec_scan's (emitted [n_steps,
    S, D + 1]). sample False: greedy, each step a replay of one CUDA
    graph; True: exact-match acceptance against the target's samples;
    "wor": draws without replacement and recursive rejection (both
    eager, eagle_tree_sample_step)."""
    S, dev = root.shape[0], root.device
    if active is None:
        active = torch.ones(S, dtype=torch.bool, device=dev)
    if sample:
        emitted, counts = [], []
        for _ in range(n_steps):
            emit, count, root, root_feat = eagle_tree_sample_step(
                target, head, t_kv, e_kv, template, root, root_feat, active,
                draws, temp, top_k, top_p, sample == "wor")
            emitted.append(emit)
            counts.append(count)
        return torch.stack(emitted), torch.stack(counts), root, root_feat
    cap = steps_capacity(n_steps)
    g = graphs_of(t_kv).step(
        ("eagle_tree", S, template.key(), cap),
        lambda: _greedy_tree_step(target, head, t_kv, e_kv, template, S,
                                  cap),
        deps=(target, head, e_kv))
    return _run_steps(g, root, root_feat, active, n_steps)


# -- the engine ---------------------------------------------------------------


class EagleChainEngine(ChainSpecEngine):
    """One stream: prefill the target and the head, then emit tokens in
    blocks of greedy EAGLE steps (one host read per block), a chain of k
    or, with `template`, a token tree; ChainSpecEngine's caches (the
    draft cache is the head's) and block loop."""

    def __init__(self, target: LlamaModel, target_cfg: ModelConfig,
                 head: EagleHead, k: int = 4, block_steps: int = 8,
                 max_seq: int = 0, prefill_chunk: int = 128,
                 template: TreeTemplate | None = None,
                 device: str | torch.device | None = None):
        super().__init__(target, target_cfg, head,
                         k=template.max_depth if template else k,
                         block_steps=block_steps, max_seq=max_seq,
                         prefill_chunk=prefill_chunk, device=device)
        self.template = template
        if template is not None:
            # one tree's nodes; the target writes all N past c
            self.n_nodes = self.overhang = template.n_nodes

    @torch.no_grad()
    def prefill(self, prompt_tokens: list[int]) -> None:
        """The target takes prompt[:-1] keeping its features; the head
        takes the same tokens, token j paired with the target's feature
        at j - 1 (zeros at the prompt's start). The last token is the
        root, paired with the feature at the last prefilled position."""
        dim = self.t_llm.dim
        feat = torch.zeros(1, dim, device=self.device)
        toks = prompt_tokens[:-1]
        for off in range(0, len(toks), self.prefill_chunk):
            part = torch.tensor(toks[off:off + self.prefill_chunk],
                                device=self.device)[None]
            pos = off + torch.arange(part.shape[1], device=self.device)[None]
            _, f = self.target(self.t_kv, part, pos, logits_mode="none",
                               return_final_hidden=True)
            f = f.float()
            eagle_forward(self.draft, self.d_kv, part,
                          torch.cat([feat[:, None], f[:, :-1]], dim=1), pos,
                          logits_mode="none")
            feat = f[:, -1]
        self._root = torch.tensor([prompt_tokens[-1]], device=self.device)
        self._root_feat = feat

    def scan(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.template is None:
            out = eagle_spec_scan(self.target, self.draft, self.t_kv,
                                  self.d_kv, self._root, self._root_feat,
                                  self.block_steps, self.k)
        else:
            out = eagle_tree_spec_scan(self.target, self.draft, self.t_kv,
                                       self.d_kv, self._root,
                                       self._root_feat, self.block_steps,
                                       self.template)
        tokens, counts, root, self._root_feat = out
        return tokens, counts, root
