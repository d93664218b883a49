"""Vectorized sampler chain over a batch of logit rows [S, V].

The reference chain order: RepeatPenalty -> TopK -> Temperature ->
Softmax -> TopP -> Normalize -> Stochastic, with the repeat-penalty
window in a per-slot ring buffer. Draws come from an explicit
torch.Generator (they differ from jax.random's for the same seed; the
greedy path draws nothing).
"""

from __future__ import annotations

import torch

from ..core.config import SamplerConfig

NEG_INF = -1e30


class PenaltyState:
    """Last-n token window per slot (ring buffer): recent [S, P] int32
    (-1 = empty), count [S] int32 (tokens pushed)."""

    def __init__(self, recent: torch.Tensor, count: torch.Tensor):
        self.recent, self.count = recent, count

    @classmethod
    def create(cls, n_slots: int, window: int,
               device: str | torch.device = "cpu") -> "PenaltyState":
        window = max(int(window), 1)
        return cls(torch.full((n_slots, window), -1, dtype=torch.int32,
                              device=device),
                   torch.zeros(n_slots, dtype=torch.int32, device=device))

    def push(self, tokens: torch.Tensor,
             active: torch.Tensor | None = None) -> None:
        """Append one token per active slot (tokens [S])."""
        S, P = self.recent.shape
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=tokens.device)
        rows = torch.arange(S, device=tokens.device)
        idx = (self.count % P).long()
        cur = self.recent[rows, idx]
        self.recent[rows, idx] = torch.where(active, tokens.to(torch.int32),
                                             cur)
        self.count += active.to(torch.int32)

    def reset_slot(self, slot: int) -> None:
        self.recent[slot] = -1
        self.count[slot] = 0

    def seed_slot(self, slot: int, tokens: list[int]) -> None:
        """Fill a slot's window with the tail of `tokens`."""
        P = self.recent.shape[1]
        tail = list(tokens)[-P:]
        row = torch.full((P,), -1, dtype=torch.int32)
        row[: len(tail)] = torch.tensor(tail, dtype=torch.int32)
        self.recent[slot] = row.to(self.recent.device)
        self.count[slot] = len(tail)


def apply_repeat_penalty(logits: torch.Tensor, state: PenaltyState,
                         cfg: SamplerConfig, eos_id: int | None = None,
                         nl_id: int | None = None) -> torch.Tensor:
    """ignore_eos masks the EOS logit; for every token in the last-n
    window positive logits are divided by penalty_repeat and negative
    ones multiplied, then the frequency/presence penalties subtract the
    counts; with penalize_nl=False the newline logit keeps its
    pre-penalty value."""
    lf = logits.float().clone()
    if cfg.ignore_eos and eos_id is not None and eos_id >= 0:
        lf[:, eos_id] = NEG_INF
    if (cfg.penalty_repeat == 1.0 and cfg.penalty_freq == 0.0
            and cfg.penalty_present == 0.0):
        return lf
    S, V = lf.shape
    P = state.recent.shape[1]
    window = min(cfg.penalty_last_n, P) if cfg.penalty_last_n > 0 else 0
    if window == 0:
        return lf
    # ring slot j's latest push index is count-1-((count-1-j) mod P)
    j = torch.arange(P, device=lf.device)[None, :]
    cnt = state.count[:, None].long()
    push_idx = cnt - 1 - torch.remainder(cnt - 1 - j, P)
    in_window = push_idx >= (cnt - window)
    idx = torch.where((state.recent >= 0) & in_window, state.recent.long(), V)
    counts = torch.zeros(S, V + 1, dtype=torch.float32, device=lf.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    counts = counts[:, :V]
    present = counts > 0
    pre = lf.clone()
    penalized = torch.where(lf > 0, lf / cfg.penalty_repeat,
                            lf * cfg.penalty_repeat)
    lf = torch.where(present, penalized, lf)
    lf = lf - counts * cfg.penalty_freq - present.float() * cfg.penalty_present
    if not cfg.penalize_nl and nl_id is not None and nl_id >= 0:
        lf[:, nl_id] = pre[:, nl_id]
    return lf


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(probs: torch.Tensor, p: float,
                min_keep: int = 1) -> torch.Tensor:
    """Nucleus filter: unnormalized probs with the tail zeroed."""
    if p >= 1.0:
        return probs
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    keep = (csum - sorted_probs) < p
    keep[..., :max(min_keep, 1)] = True
    thr = torch.where(keep, sorted_probs, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(probs >= thr, probs, 0.0)


def sample_logits(logits: torch.Tensor, cfg: SamplerConfig,
                  state: PenaltyState | None = None,
                  vocab_size: int | None = None, eos_id: int | None = None,
                  nl_id: int | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Full chain -> sampled token ids [S] (int64)."""
    lf = logits.float()
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        lf = lf.clone()
        lf[..., vocab_size:] = NEG_INF
    if state is not None:
        lf = apply_repeat_penalty(lf, state, cfg, eos_id=eos_id, nl_id=nl_id)
    if cfg.temperature <= 0.0:
        return torch.argmax(lf, dim=-1)
    lf = apply_top_k(lf, cfg.top_k)
    lf = lf / cfg.temperature
    probs = torch.softmax(lf, dim=-1)
    probs = apply_top_p(probs, cfg.top_p, cfg.min_keep)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
