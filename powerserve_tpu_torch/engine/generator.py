"""Generation engine: chunked prefill, then block decode.

Prefill feeds the prompt in hyper-param-sized chunks; decode runs
`decode_horizon` steps per block with the logits head and the sampler
chain, then rolls back the steps after a stop — the JAX engine's
protocol, so the emitted tokens, the KV cache and the penalty window end
in the same state. The cache is updated in place.

A decode step replays a CUDA graph (engine/graphs.py) over the engine's
static buffers (the token, `active`, the block's outputs and a step
counter): forward, sampler chain, the argmax or (sampled) the draw from
the engine's one-slot Philox stream (a DrawState seeded from
hp.sampler.seed; csrc/sample.cu on the card), and the penalty push.
Prefill, and the rollback after a stop, stay eager.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from ..core.config import HyperParams, ModelConfig
from ..core.device import resolve_device
from ..core.logging import Timer, get_logger
from ..core.trace import Trace
from ..kv.cache import KVCache
from ..models.llama import LlamaModel
from ..sampling.sampler import (DrawState, PenaltyState,
                                categorical_from_dist, sample_dist)
from .graphs import StepGraphs

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
        # every row of a sampled step draws from one stream
        self.draws = DrawState.create(1, self.device, self.hp.sampler.seed)
        self.horizon = max(int(self.hp.decode_horizon), 1)
        # the decode steps' static buffers and graphs
        dev, S = self.device, self.n_slots
        self.bufs = dict(tok=torch.zeros(S, dtype=torch.int64, device=dev),
                         active=torch.zeros(S, dtype=torch.bool, device=dev),
                         out=torch.zeros(S, self.horizon, dtype=torch.int64,
                                         device=dev),
                         step=torch.zeros(1, dtype=torch.int64, device=dev))
        self.graphs = StepGraphs(dev)

    def _active(self, slot: int) -> torch.Tensor:
        """The static `active` buffer, set to slot alone."""
        active = self.bufs["active"]
        active.zero_()
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
            with Trace.span(Trace.SPAN_PREFILL):
                logits = self.model(self.kv, toks.to(self.device),
                                    pos.to(self.device), active=active,
                                    logits_mode="last")
        self._sync()
        if stats is not None:
            stats.prefill_tokens += n
            stats.prefill_ms += timer.elapsed_time_ms()
        self.penalty.seed_slot(slot, list(prompt_tokens))
        return None if logits is None else logits[slot]

    def _step_graph(self):
        """The decode step for the sampler settings as they are now."""
        # (the seed lives in the draw state, not in the body)
        scfg = dataclasses.replace(self.hp.sampler, seed=0)
        key = ("decode", dataclasses.astuple(scfg))
        return self.graphs.step(key, lambda: (_decode_step(
            self.model, self.kv, self.penalty, self.bufs, scfg,
            self.cfg.llm.vocab_size, self.eos_id, self.nl_id, self.draws),
            self.bufs))

    @torch.no_grad()
    def _decode_block(self, cur: int, slot: int) -> list[int]:
        """`horizon` greedy-or-sampled steps from token `cur`."""
        b = self.bufs
        self._active(slot)
        b["tok"].fill_(cur)
        b["step"].zero_()
        g = self._step_graph()
        # around the replays: a range inside the step's body would be
        # recorded only when the graph is captured
        with Trace.span(Trace.SPAN_DECODE):
            for _ in range(self.horizon):
                g()
        return b["out"][slot].tolist()

    def generate(self, prompt_tokens: list[int], n_predict: int,
                 stop_fn: Callable[[int], bool] | None = None,
                 slot: int = 0,
                 stats: GenerationStats | None = None) -> Iterator[int]:
        """Streaming generation: prefill prompt[:-1], then decode from
        the last prompt token."""
        stats = stats if stats is not None else GenerationStats()
        self.prefill(prompt_tokens[:-1], slot=slot, stats=stats)
        yield from self.decode(int(prompt_tokens[-1]), n_predict, stop_fn,
                               slot, stats, list(prompt_tokens))

    def decode(self, cur: int, n_predict: int,
               stop_fn: Callable[[int], bool] | None = None, slot: int = 0,
               stats: GenerationStats | None = None,
               history: list[int] = ()) -> Iterator[int]:
        """Up to n_predict tokens decoded in blocks from token `cur` at the
        slot's position; after a stop the unconsumed steps' KV entries
        are rolled back and the penalty window re-seeded from history +
        the emitted tokens."""
        stats = stats if stats is not None else GenerationStats()
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
                self.kv.rollback(len(block) - stopped_at,
                                 active=self._active(slot))
                self.penalty.seed_slot(slot, list(history) + emitted)
                return
            cur = block[-1]


def _decode_step(model: LlamaModel, kv: KVCache, penalty: PenaltyState,
                 bufs: dict, scfg, vocab: int, eos_id: int,
                 nl_id: int, draws: DrawState) -> Callable[[], None]:
    """The body of one decode step over the engine's buffers: the argmax
    (greedy, scfg.temperature <= 0) or a draw from `draws` (every row of
    the distribution [S, V] from its one stream), pushed to the penalty
    window, feeds the next step and goes to column `step` of out."""
    tok, active, out, step = (bufs[k] for k in ("tok", "active", "out",
                                                "step"))
    greedy = scfg.temperature <= 0.0

    def body():
        pos = torch.where(active, kv.pos.to(torch.int64), -1)
        logits = model(kv, tok[:, None], pos[:, None], active=active,
                       logits_mode="last")
        dist = sample_dist(logits, scfg, penalty, vocab_size=vocab,
                           eos_id=eos_id if eos_id >= 0 else None,
                           nl_id=nl_id if nl_id >= 0 else None)
        nxt = categorical_from_dist(dist, None if greedy else draws)
        penalty.push(nxt, active)
        tok.copy_(nxt)
        out.index_copy_(1, step, nxt[:, None])
        step.add_(1)

    return body
