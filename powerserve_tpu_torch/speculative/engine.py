"""Speculation statistics, shared by the engines, `run` and the scheduler,
and the host tree engine (the JAX package's speculative/engine.py).

SpeculativeEngine grows a token tree on the host, one step at a time:
  1. grow the tree level by level (speculative/tree.py grow_tree), each
     level ONE batched draft forward over its frontier, padded to
     draft_batch_size rows;
  2. ONE batched target forward over the flattened tree, padded to
     draft_batch_size rows, with the ancestor attention mask;
  3. walk the acceptance chain greedily and commit the accepted entries
     by gather-compaction (commit_tokens).

KV bookkeeping per step (c = tokens committed so far): node i is written
at cache position c + i in both caches, its RoPE position is c +
depth(i); a draft level's rows see the committed prefix (the mask as it
was at the tree's start) and their own ancestors-or-self among the
nodes; after the verify both caches roll back to c, gather the accepted
entries to the front and advance. Padded rows have cache position -1:
they write nothing, see only the mask, and their outputs are dropped.
The host reads each level's candidates and the verify's tokens, so a
step reads the device once per level (the on-device engines are
speculative/chain.py and speculative/device_tree.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..core.logging import Timer
from ..core.trace import Trace
from ..kv.cache import KVCache
from ..models.llama import DECODE_MAX_TQ, LlamaModel
from ..sampling.sampler import draft_probs
from .tree import SpeculativeConfig, TokenTree, grow_tree


@dataclass
class SpecStats:
    """Acceptance statistics of speculative decoding."""

    steps: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    decode_ms: float = 0.0

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / self.steps if self.steps else 0.0

    def summary(self) -> str:
        return (f"spec: {self.steps} steps, {self.emitted} tokens, "
                f"{self.tokens_per_step:.2f} tok/step, "
                f"accept rate {self.accept_rate:.2%}")


class SpeculativeEngine:
    """The host-driven token-tree engine: one stream, a target and a
    separate draft model."""

    def __init__(self, target: LlamaModel, target_cfg: ModelConfig,
                 draft: LlamaModel, draft_cfg: ModelConfig,
                 spec_cfg: SpeculativeConfig | None = None,
                 max_seq: int = 0, prefill_chunk: int = 128,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.target = target.to(self.device)
        self.draft = draft.to(self.device)
        self.tcfg, self.dcfg = target_cfg, draft_cfg
        self.cfg = spec_cfg or SpeculativeConfig()
        if self.cfg.draft_batch_size > DECODE_MAX_TQ:
            raise ValueError(f"draft_batch_size {self.cfg.draft_batch_size}:"
                             f" a verify attends through flash-decode, at "
                             f"most {DECODE_MAX_TQ} rows")
        if draft_cfg.llm.vocab_size != target_cfg.llm.vocab_size:
            raise ValueError(f"draft vocab {draft_cfg.llm.vocab_size} != "
                             f"target vocab {target_cfg.llm.vocab_size}")
        self.max_seq = max_seq or min(target_cfg.llm.seq_len,
                                      draft_cfg.llm.seq_len)
        self.prefill_chunk = prefill_chunk
        t, d = target_cfg.llm, draft_cfg.llm
        self.t_kv = KVCache.create(t.n_layers, 1, self.max_seq,
                                   t.n_kv_heads, t.head_size, self.device)
        self.d_kv = KVCache.create(d.n_layers, 1, self.max_seq,
                                   d.n_kv_heads, d.head_size, self.device)
        self.commit_len = 0
        self._mask0 = torch.zeros_like(self.d_kv.mask)

    def reset(self) -> None:
        self.t_kv.reset_slot(0)
        self.d_kv.reset_slot(0)
        self.commit_len = 0

    def _rows(self, values, fill: int = -1) -> torch.Tensor:
        """int64 [1, draft_batch_size] on the device: values, then fill."""
        row = np.full(self.cfg.draft_batch_size, fill, np.int64)
        row[:len(values)] = values
        return torch.from_numpy(row[None]).to(self.device)

    @torch.no_grad()
    def prefill(self, prompt_tokens: list[int]) -> None:
        """Both caches take prompt[:-1]; the last token is the first
        tree's root."""
        toks = np.asarray(prompt_tokens[:-1], np.int64)
        for off in range(0, len(toks), self.prefill_chunk):
            part = torch.from_numpy(toks[off:off + self.prefill_chunk])
            pos = self.commit_len + off + torch.arange(len(part))
            args = (part[None].to(self.device), pos[None].to(self.device))
            self.target(self.t_kv, *args, logits_mode="none")
            self.draft(self.d_kv, *args, logits_mode="none")
        self.commit_len += len(toks)
        self._root = int(prompt_tokens[-1])

    def _intra(self, tree: TokenTree, rows: list[int]) -> torch.Tensor:
        """bool [draft_batch_size, draft_batch_size]: row r sees the
        ancestors-or-self of node rows[r]; padded rows see no key."""
        npad = self.cfg.draft_batch_size
        intra = np.zeros((npad, npad), bool)
        anc = tree.ancestor_mask()
        for r, idx in enumerate(rows):
            intra[r, :tree.size] = anc[idx]
        return torch.from_numpy(intra).to(self.device)

    def _draft_level(self, tree: TokenTree, frontier_tokens: np.ndarray,
                     frontier_idx: list[int]) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """One batched draft forward over a frontier level."""
        F = len(frontier_idx)
        c = self.commit_len
        depths = [tree.nodes[i].depth for i in frontier_idx]
        with Trace.span(Trace.SPAN_DRAFT_FORWARD):
            logits = self.draft(
                self.d_kv, self._rows(frontier_tokens, 0),
                self._rows(c + np.asarray(depths)),
                cache_positions=self._rows(c + np.asarray(frontier_idx)),
                intra_mask=self._intra(tree, frontier_idx),
                key_positions=self._rows(c + np.arange(tree.size)),
                attn_mask=self._mask0, logits_mode="all")
        probs, ids = draft_probs(logits[0, :F, :self.dcfg.llm.vocab_size],
                                 self.cfg.draft_top_k,
                                 self.cfg.draft_temperature)
        return probs.cpu().numpy(), ids.cpu().numpy()

    @torch.no_grad()
    def step(self, stats: SpecStats | None = None) -> list[int]:
        """One draft -> verify -> accept cycle; returns the emitted
        tokens."""
        c = self.commit_len
        self._mask0.copy_(self.d_kv.mask)

        def draft_step(tokens, depths, tree, frontier_idx):
            return self._draft_level(tree, tokens, frontier_idx)

        tree = grow_tree(self._root, self.cfg, draft_step)
        n = tree.size
        with Trace.span(Trace.SPAN_VERIFY):
            sampled = self.target(
                self.t_kv, self._rows(tree.tokens(), 0),
                self._rows(c + tree.depths()),
                cache_positions=self._rows(c + np.arange(n)),
                intra_mask=self._intra(tree, list(range(n))),
                logits_mode="argmax_all")
        sampled = sampled[0, :n].cpu().numpy()
        accepted, emitted = tree.accepted_chain(sampled)
        # both caches back to the committed prefix, then the root's and
        # the accepted nodes' entries to the front
        chain = [0] + accepted
        n_commit = torch.tensor([len(chain)], device=self.device)
        src = self._rows(c + np.asarray(chain))
        for kv in (self.t_kv, self.d_kv):
            kv.rollback(kv.pos - c)
            kv.commit_tokens(torch.arange(1), src, n_commit)
        self.commit_len = c + len(chain)
        self._root = emitted[-1]
        if stats is not None:
            stats.steps += 1
            stats.drafted += n - 1
            stats.accepted += len(accepted)
            stats.emitted += len(emitted)
        return emitted

    def generate(self, prompt_tokens: list[int], n_predict: int,
                 stop_fn: Callable[[int], bool] | None = None,
                 stats: SpecStats | None = None) -> Iterator[int]:
        """Up to n_predict greedy tokens, streamed step by step."""
        stats = stats if stats is not None else SpecStats()
        self.reset()
        self.prefill(prompt_tokens)
        timer = Timer()
        out = 0
        while out < n_predict:
            # a step writes one padded tree past the committed prefix
            if self.max_seq - self.commit_len < self.cfg.draft_batch_size:
                return
            for t in self.step(stats):
                out += 1
                stats.decode_ms = timer.elapsed_time_ms()
                yield t
                if (stop_fn is not None and stop_fn(t)) or out >= n_predict:
                    return
