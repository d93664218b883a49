"""Generation engine: chunked prefill, then block decode.

Prefill feeds the prompt in hyper-param-sized chunks; decode runs
`decode_horizon` steps per block with the logits head and the sampler
chain, then rolls back the steps after a stop — the JAX engine's
protocol, so the emitted tokens, the KV cache and the penalty window end
in the same state. Steps are a Python loop; the cache is updated in
place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from ..core.config import HyperParams, ModelConfig
from ..core.device import resolve_device
from ..core.logging import Timer, get_logger
from ..kv.cache import KVCache
from ..models.llama import LlamaModel
from ..sampling.sampler import PenaltyState, sample_logits

log = get_logger("engine")


@dataclass
class GenerationStats:
    """Prefill/decode token throughput."""

    prefill_tokens: int = 0
    prefill_ms: float = 0.0
    decode_tokens: int = 0
    decode_ms: float = 0.0

    @property
    def prefill_speed(self) -> float:
        return (self.prefill_tokens / self.prefill_ms * 1e3
                if self.prefill_ms else 0.0)

    @property
    def decode_speed(self) -> float:
        return (self.decode_tokens / self.decode_ms * 1e3
                if self.decode_ms else 0.0)


class InferenceEngine:
    """Single-model engine over a fixed slot batch; slot 0 serves
    single-sequence generate()."""

    def __init__(self, model: LlamaModel, cfg: ModelConfig,
                 hp: HyperParams | None = None, eos_id: int = -1,
                 nl_id: int = -1,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.hp = hp or HyperParams()
        self.eos_id = eos_id
        self.nl_id = nl_id
        llm = cfg.llm
        self.max_seq = self.hp.max_seq_len or llm.seq_len
        self.n_slots = self.hp.max_slots
        if self.hp.kv_dtype != "int8":
            raise ValueError("the port keeps an int8 KV cache only")
        self.kv = KVCache.create(llm.n_layers, self.n_slots, self.max_seq,
                                 llm.n_kv_heads, llm.head_size, self.device)
        self.penalty = PenaltyState.create(
            self.n_slots, max(self.hp.sampler.penalty_last_n, 1), self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.hp.sampler.seed)
        self.horizon = max(int(self.hp.decode_horizon), 1)

    def _active(self, slot: int) -> torch.Tensor:
        active = torch.zeros(self.n_slots, dtype=torch.bool,
                             device=self.device)
        active[slot] = True
        return active

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset(self, slot: int = 0) -> None:
        self.kv.reset_slot(slot)
        self.penalty.reset_slot(slot)

    @torch.no_grad()
    def prefill(self, prompt_tokens: list[int], slot: int = 0,
                stats: GenerationStats | None = None):
        """Feed the whole prompt; returns the last token's logits (or
        None for an empty prompt)."""
        chunk = max(int(self.hp.batch_size), 1)
        n = len(prompt_tokens)
        start = int(self.kv.pos[slot])
        timer = Timer()
        logits = None
        active = self._active(slot)
        for off in range(0, n, chunk):
            part = prompt_tokens[off: off + chunk]
            use = len(part)
            toks = torch.zeros(self.n_slots, use, dtype=torch.int64)
            pos = torch.full((self.n_slots, use), -1, dtype=torch.int64)
            toks[slot] = torch.tensor(part, dtype=torch.int64)
            pos[slot] = start + off + torch.arange(use)
            logits = self.model(self.kv, toks.to(self.device),
                                pos.to(self.device), active=active,
                                logits_mode="last")
        self._sync()
        if stats is not None:
            stats.prefill_tokens += n
            stats.prefill_ms += timer.elapsed_time_ms()
        self.penalty.seed_slot(slot, list(prompt_tokens))
        return None if logits is None else logits[slot]

    @torch.no_grad()
    def _decode_block(self, cur: int, slot: int) -> list[int]:
        """`horizon` greedy-or-sampled steps from token `cur`."""
        llm = self.cfg.llm
        scfg = self.hp.sampler
        active = self._active(slot)
        tok = torch.full((self.n_slots,), cur, dtype=torch.int64,
                         device=self.device)
        out = []
        for _ in range(self.horizon):
            pos = torch.where(active, self.kv.pos.to(torch.int64), -1)
            logits = self.model(self.kv, tok[:, None], pos[:, None],
                                active=active, logits_mode="last")
            tok = sample_logits(
                logits, scfg, self.penalty, vocab_size=llm.vocab_size,
                eos_id=self.eos_id if self.eos_id >= 0 else None,
                nl_id=self.nl_id if self.nl_id >= 0 else None,
                generator=self.generator)
            self.penalty.push(tok, active)
            out.append(tok)
        return torch.stack(out, dim=1)[slot].tolist()

    def generate(self, prompt_tokens: list[int], n_predict: int,
                 stop_fn: Callable[[int], bool] | None = None,
                 slot: int = 0,
                 stats: GenerationStats | None = None) -> Iterator[int]:
        """Streaming generation: prefill prompt[:-1], then decode from
        the last prompt token."""
        stats = stats if stats is not None else GenerationStats()
        self.prefill(prompt_tokens[:-1], slot=slot, stats=stats)
        cur = int(prompt_tokens[-1])
        timer = Timer()
        emitted: list[int] = []
        out = 0
        while out < n_predict:
            block = self._decode_block(cur, slot)
            stopped_at = -1
            for h, t in enumerate(block):
                if out >= n_predict:
                    stopped_at = h
                    break
                emitted.append(t)
                out += 1
                stats.decode_tokens += 1
                stats.decode_ms = timer.elapsed_time_ms()
                yield t
                if stop_fn is not None and stop_fn(t):
                    stopped_at = h + 1
                    break
            if 0 <= stopped_at < len(block):
                # drop the KV entries of the unconsumed steps and re-seed
                # the penalty window from the actual sequence
                self.kv.rollback(len(block) - stopped_at,
                                 active=self._active(slot))
                self.penalty.seed_slot(slot, list(prompt_tokens) + emitted)
                return
            cur = block[-1]
