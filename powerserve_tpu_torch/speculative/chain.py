"""Chain speculative decoding on the device.

Per speculative step, with draft length k:
  1. draft: k + 1 sequential draft forwards (Tq = 1) feeding [root, d0 ..
     d_{k-1}]; the last exists only to write d_{k-1}'s K/V, so the draft
     cache stays complete when all k drafts are accepted.
  2. verify: one target forward with Tq = k + 1 over the fed chain
     (causal), which gives the target's choice after every prefix.
  3. accept: greedy (chain_spec_scan), the longest prefix with d_i equal
     to the target's argmax; or speculative sampling
     (chain_spec_sample_scan): d_i is accepted with probability
     min(1, p_i(d_i) / q_i(d_i)), and the first rejection resamples from
     the residual (p - q)^+, so the emitted stream is distributed as the
     target's own samples. A slot at temperature <= 0 has one-hot p and q
     and reduces to the greedy scheme exactly.
  4. commit: both caches roll back the rejected entries; the next root
     is the target's token at the first rejection (or the bonus token).

Chain drafting keeps every K/V position sequential, so accepted entries
are already where they belong and the losers roll back with one masked
rollback. The JAX package runs the steps inside one lax.scan. Here a
step (its k + 1 draft forwards, the verify, the accept count and both
rollbacks) is one CUDA graph, replayed once per step (engine/graphs.py):
chain_spec_scan's greedy step, or the scheduler's step over its buffers
(sample_step: greedy, or with draws from per-slot Philox streams
through csrc/sample.cu, launches a graph captures);
chain_spec_sample_scan is the eager loop of the same steps. All keep
acceptance, counts and rollback on the device and read the host once
per block.

Self-drafting (LayerSkip): the draft is the target's own first n layers
with the shared final norm and lm_head (`self_draft_model`), costing n/L
of a target step and no extra weights. Drafts of at most FUSE_MAX_LAYERS
layers run the fused decode-layer chain (ops/fused.py), as the JAX
package's "auto" rule does. A verify over the paged pool takes the
deferred K/V route (models/llama.py), the route of the state mode of
paged flash-decode.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Iterator

import numpy as np
import torch

from ..core.config import LLMConfig, ModelConfig
from ..core.device import resolve_device
from ..core.logging import Timer
from ..engine.graphs import graphs_of, steps_capacity
from ..kv.cache import KVCache
from ..kv.paged import PagedKVCache
from ..models.llama import LlamaModel
from ..sampling.sampler import (DrawState, categorical_from_dist,
                                sample_dist_batched, uniform_draws)
from .engine import SpecStats

__all__ = ["chain_spec_scan", "chain_spec_sample_scan", "ChainSpecEngine",
           "sample_step", "self_draft_config", "self_draft_model",
           "with_draft_head", "draft_fuse"]

# drafts this shallow are launch-bound: they run the fused layer chain
FUSE_MAX_LAYERS = 4


def draft_fuse(d_llm: LLMConfig) -> bool:
    return d_llm.n_layers <= FUSE_MAX_LAYERS


def self_draft_config(llm: LLMConfig, n_layers: int) -> LLMConfig:
    """The config of a self-draft of the first `n_layers` layers."""
    if not 0 < n_layers <= llm.n_layers:
        raise ValueError(f"draft layers {n_layers} vs {llm.n_layers}")
    return dataclasses.replace(llm, n_layers=n_layers)


def self_draft_model(model: LlamaModel, n_layers: int) -> LlamaModel:
    """A view of the target's first n_layers layers, its embedding, final
    norm and head (no weight is copied)."""
    return LlamaModel(self_draft_config(model.llm, n_layers), model.embed,
                      list(model.layers[:n_layers]), model.out_norm,
                      model.lm_head, model.lm_head_lr)


def with_draft_head(model: LlamaModel, lm_head_lr: tuple) -> LlamaModel:
    """A view of `model` whose head is the factored (U, V)."""
    return LlamaModel(model.llm, model.embed, list(model.layers),
                      model.out_norm, model.lm_head, lm_head_lr)


def _verify_update(kv: KVCache) -> str:
    return "deferred" if isinstance(kv, PagedKVCache) else "inline"


def _chain_step(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                d_kv: KVCache, S: int, k: int, cap: int) -> tuple:
    """The body of one greedy chain step and its buffers: root [S] feeds
    the drafts and takes the next root; the step's tokens [S, k + 1] and
    counts [S] go to row `step` of tokens [cap, S, k + 1] and counts
    [cap, S]."""
    dev = t_kv.device
    root = torch.zeros(S, dtype=torch.int64, device=dev)
    tokens = torch.zeros(cap, S, k + 1, dtype=torch.int64, device=dev)
    counts = torch.zeros(cap, S, dtype=torch.int64, device=dev)
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    lanes = torch.arange(k + 1, device=dev)
    fuse = draft_fuse(draft.llm)
    update = _verify_update(t_kv)
    refs = [weakref.ref(o) for o in (target, draft, t_kv, d_kv)]

    def body():
        tgt, drf, tkv, dkv = (r() for r in refs)
        c = tkv.pos.long()
        fed, tok = [root], root
        for j in range(k + 1):
            nxt = drf(dkv, tok[:, None], dkv.pos.long()[:, None],
                      logits_mode="argmax", fuse_layers=fuse).long()
            if j < k:
                fed.append(nxt)
                tok = nxt
        fed = torch.stack(fed, dim=1)  # [S, k+1] = [root, d0 .. d_{k-1}]
        sampled = tgt(tkv, fed, c[:, None] + lanes[None, :],
                      logits_mode="argmax_all", kv_update=update).long()
        match = (sampled[:, :k] == fed[:, 1:]).long()
        n_acc = match.cumprod(dim=1).sum(dim=1)  # [S] in [0, k]
        drop = k - n_acc
        dkv.rollback(drop)
        tkv.rollback(drop)
        root.copy_(sampled.gather(1, n_acc[:, None])[:, 0])
        tokens.index_copy_(0, step, sampled[None])
        counts.index_copy_(0, step, (n_acc + 1)[None])
        step.add_(1)

    return body, dict(root=root, tokens=tokens, counts=counts, step=step)


@torch.no_grad()
def chain_spec_scan(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                    d_kv: KVCache, root: torch.Tensor, n_steps: int,
                    k: int) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """n_steps greedy chain steps for every slot of the caches, each
    step a replay of one CUDA graph (kept with t_kv).

    root: int64 [S], each slot's last committed token (it feeds the first
    draft). Returns (tokens [n_steps, S, k + 1], counts [n_steps, S],
    root [S]) on the device: step i emitted tokens[i, s, :counts[i, s]].
    """
    S = root.shape[0]
    cap = steps_capacity(n_steps)
    g = graphs_of(t_kv).step(
        ("chain", S, k, cap),
        lambda: _chain_step(target, draft, t_kv, d_kv, S, k, cap),
        deps=(target, draft, d_kv))
    b = g.bufs
    b["root"].copy_(root)
    b["step"].zero_()
    for _ in range(n_steps):
        g()
    return (b["tokens"][:n_steps].clone(), b["counts"][:n_steps].clone(),
            b["root"].clone())


@torch.no_grad()
def chain_spec_sample_scan(target: LlamaModel, draft: LlamaModel,
                           t_kv: KVCache, d_kv: KVCache, root: torch.Tensor,
                           n_steps: int, k: int, active: torch.Tensor,
                           draws: DrawState | None,
                           temp: torch.Tensor, top_k: torch.Tensor,
                           top_p: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """n_steps steps of speculative sampling over a batch of slots.

    root int64 [S]; active bool [S]; temp/top_k/top_p [S] the slots'
    sampler settings; draws the slots' streams (None: every slot is at
    temperature <= 0 and nothing is drawn; a greedy slot's one-hot
    distributions make its draws the greedy scheme's). Returns
    (emitted [n_steps, S, k + 1], counts [n_steps, S], root [S]): each
    row holds the accepted drafts, then the resampled or bonus token, -1
    beyond its count (and everywhere for inactive slots)."""
    emitted, counts = [], []
    for _ in range(n_steps):
        emit, count, root = _sample_step(target, draft, t_kv, d_kv, root, k,
                                         active, draws, temp, top_k,
                                         top_p)
        emitted.append(emit)
        counts.append(count)
    return torch.stack(emitted), torch.stack(counts), root


def _sample_step(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                 d_kv: KVCache, root: torch.Tensor, k: int,
                 active: torch.Tensor, draws: DrawState | None,
                 temp: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """One step of chain_spec_sample_scan: (emitted [S, k + 1], counts
    [S], next root [S])."""
    S = root.shape[0]
    dev = root.device
    V = target.llm.vocab_size
    lanes = torch.arange(k + 1, device=dev)
    fuse = draft_fuse(draft.llm)
    rep = lambda a: a.repeat_interleave(k + 1)  # noqa: E731
    c = t_kv.pos.long()
    # 1. k sampled drafts (k + 1 forwards: the last writes d_{k-1})
    fed, qs, tok = [root], [], root
    for j in range(k + 1):
        pos = torch.where(active, d_kv.pos.long(), -1)[:, None]
        logits = draft(d_kv, tok[:, None], pos, active=active,
                       logits_mode="last", fuse_layers=fuse)
        if j < k:
            q = sample_dist_batched(logits[:, :V], temp, top_k, top_p,
                                    vocab_size=V)
            tok = categorical_from_dist(q, draws)
            fed.append(tok)
            qs.append(q)
    fed = torch.stack(fed, dim=1)  # [S, k+1]
    q_d = torch.stack(qs, dim=1)  # [S, k, V]; q_j drew d_j
    # 2. one batched verify
    positions = torch.where(active[:, None], c[:, None] + lanes[None, :], -1)
    logits = target(t_kv, fed, positions, active=active, logits_mode="all",
                    kv_update=_verify_update(t_kv))
    p = sample_dist_batched(
        logits.reshape(S * (k + 1), -1)[:, :V], rep(temp), rep(top_k),
        rep(top_p), vocab_size=V).reshape(S, k + 1, V)
    # 3. rejection-sample acceptance
    d = fed[:, 1:]
    p_at_d = p[:, :k].gather(2, d[..., None])[..., 0]
    q_at_d = q_d.gather(2, d[..., None])[..., 0]
    u = uniform_draws(draws, S, k, dev)
    accept = (u * q_at_d < p_at_d).long()
    n_acc = accept.cumprod(dim=1).sum(dim=1)  # [S]
    # 4. resample: the residual (p - q)^+ at the rejected position, p
    # itself at the bonus position (n_acc == k)
    sel = n_acc[:, None, None].expand(S, 1, V)
    p_sel = p.gather(1, sel)[:, 0]
    q_pad = torch.cat([q_d, torch.zeros(S, 1, V, device=dev)], dim=1)
    q_sel = q_pad.gather(1, sel)[:, 0]
    residual = torch.clamp(p_sel - q_sel, min=0.0)
    rsum = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(rsum > 1e-12,
                           residual / torch.clamp(rsum, min=1e-30), p_sel)
    new_root = torch.where(active, categorical_from_dist(residual, draws),
                           root)
    emit = torch.where(
        lanes[None, :] < n_acc[:, None],
        torch.cat([d, torch.zeros_like(d[:, :1])], dim=1),
        torch.where(lanes[None, :] == n_acc[:, None], new_root[:, None], -1))
    # 5. both caches keep the accepted prefix and the root's entry
    drop = torch.where(active, k - n_acc, 0)
    d_kv.rollback(drop)
    t_kv.rollback(drop)
    return (torch.where(active[:, None], emit, -1),
            torch.where(active, n_acc + 1, 0), new_root)


def sample_step(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                d_kv: KVCache, bufs: dict, k: int,
                draws: DrawState | None):
    """The body of one chain_spec_sample_scan step over the scheduler's
    buffers, replayed as one CUDA graph: reads bufs root, active, temp,
    top_k and top_p ([S]); writes the step's emitted [S, k + 1] and
    counts [S] to row `step` of bufs spec_emitted [H, S, k + 1] and
    spec_counts [H, S], and the next root to bufs root. Its draws come
    from `draws` (None: every slot greedy, nothing drawn)."""
    b = bufs
    step = b["step"]

    def body():
        emit, count, root = _sample_step(
            target, draft, t_kv, d_kv, b["root"], k, b["active"], draws,
            b["temp"], b["top_k"], b["top_p"])
        b["spec_emitted"].index_copy_(0, step, emit[None])
        b["spec_counts"].index_copy_(0, step, count[None])
        b["root"].copy_(root)
        step.add_(1)

    return body


class ChainSpecEngine:
    """One stream: prefill both models, then emit tokens in blocks of
    greedy speculative steps (one host read per block). A step drafts
    n_nodes - 1 tokens and emits up to `width`; speculative/device_tree.py
    DeviceTreeEngine runs token trees through the same caches and
    loop."""

    def __init__(self, target: LlamaModel, target_cfg: ModelConfig,
                 draft: LlamaModel | None = None, self_draft_layers: int = 0,
                 k: int = 4, block_steps: int = 8, max_seq: int = 0,
                 prefill_chunk: int = 128,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.target = target.to(self.device)
        if self_draft_layers:
            self.draft = self_draft_model(self.target, self_draft_layers)
        elif draft is None:
            raise ValueError("give a draft model or self_draft_layers")
        else:
            self.draft = draft.to(self.device)
        self.t_llm, self.d_llm = target_cfg.llm, self.draft.llm
        if self.d_llm.vocab_size != self.t_llm.vocab_size:
            raise ValueError(f"draft vocab {self.d_llm.vocab_size} != "
                             f"target vocab {self.t_llm.vocab_size}")
        self.k = k
        self.n_nodes = self.width = k + 1
        # entries a block may write past the ones it commits
        self.overhang = 1
        self.block_steps = block_steps
        self.max_seq = max_seq or self.t_llm.seq_len
        self.prefill_chunk = prefill_chunk
        t, d = self.t_llm, self.d_llm
        self.t_kv = KVCache.create(t.n_layers, 1, self.max_seq,
                                   t.n_kv_heads, t.head_size, self.device)
        self.d_kv = KVCache.create(d.n_layers, 1, self.max_seq,
                                   d.n_kv_heads, d.head_size, self.device)

    def reset(self) -> None:
        """Empty both caches in place (their step graphs stay valid)."""
        self.t_kv.reset_slot(0)
        self.d_kv.reset_slot(0)

    @torch.no_grad()
    def prefill(self, prompt_tokens: list[int]) -> None:
        """Both caches take prompt[:-1]; the last token is the root."""
        toks = np.asarray(prompt_tokens[:-1], np.int64)
        for off in range(0, len(toks), self.prefill_chunk):
            part = torch.from_numpy(toks[off:off + self.prefill_chunk])
            pos = off + torch.arange(len(part))
            args = (part[None].to(self.device), pos[None].to(self.device))
            self.target(self.t_kv, *args, logits_mode="none")
            self.draft(self.d_kv, *args, logits_mode="none")
        self._root = torch.tensor([prompt_tokens[-1]], device=self.device)

    def scan(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One block of steps from the root: (tokens [block_steps, 1,
        width], counts [block_steps, 1], next root)."""
        return chain_spec_scan(self.target, self.draft, self.t_kv, self.d_kv,
                               self._root, self.block_steps, self.k)

    def generate(self, prompt_tokens: list[int], n_predict: int,
                 stop_fn: Callable[[int], bool] | None = None,
                 stats: SpecStats | None = None) -> Iterator[int]:
        """Up to n_predict greedy tokens, `block_steps` speculative steps
        per host read."""
        stats = stats if stats is not None else SpecStats()
        self.reset()
        self.prefill(prompt_tokens)
        timer = Timer()
        out = 0
        W = self.width
        committed = len(prompt_tokens) - 1  # the target cache's pos
        while out < n_predict:
            # a block commits up to block_steps * width entries past the
            # committed prefix, and writes up to `overhang` past them
            if (self.max_seq - committed
                    < self.block_steps * W + self.overhang):
                return
            tokens, counts, self._root = self.scan()
            # the block's one host read
            got = torch.cat([tokens[:, 0].flatten(), counts[:, 0]]).tolist()
            n_tok = self.block_steps * W
            tokens = [got[i:i + W] for i in range(0, n_tok, W)]
            counts = got[n_tok:]
            committed += sum(counts)
            for i in range(self.block_steps):
                stats.steps += 1
                stats.drafted += self.n_nodes - 1
                stats.accepted += counts[i] - 1
                for t in tokens[i][:counts[i]]:
                    stats.emitted += 1
                    out += 1
                    stats.decode_ms = timer.elapsed_time_ms()
                    yield t
                    if (stop_fn is not None and stop_fn(t)) \
                            or out >= n_predict:
                        return
