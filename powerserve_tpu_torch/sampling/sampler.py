"""Vectorized sampler chain over a batch of logit rows [S, V].

The reference chain order: RepeatPenalty -> TopK -> Temperature ->
Softmax -> TopP -> Normalize -> Stochastic, with the repeat-penalty
window in a per-slot ring buffer. Draws come from a DrawState: one
Philox stream per slot, its seed and counter in device buffers
(ops/sample.py, csrc/sample.cu on the card). They differ from
jax.random's for the same seed; the greedy path draws nothing.

`sample_dist_batched` / `sample_logits_batched` are the scheduler's
chain: every slot carries its own temperature, top-k, top-p and
penalties as [S] tensors, and draws from its own stream, so a request
with a seed reproduces its samples whatever else runs. Every draw is a
kernel launch that reads the counters on the device, so the steps that
draw are captured and replayed as CUDA graphs. `categorical_from_dist`,
`uniform_draws` and `gumbel_draws` are the draws of speculative sampling
(a draft's sample, the acceptance uniforms, the residual resample, a
WOR tree's Gumbel top-k), from the same per-slot streams.
"""

from __future__ import annotations

import torch

from ..core.config import SamplerConfig
from ..ops.sample import sample_categorical, sample_gumbel, sample_uniform

NEG_INF = -1e30


def _int64(seed: int) -> int:
    """A seed as the int64 whose bits are seed mod 2^64."""
    seed %= 1 << 64
    return seed - (1 << 64) if seed >= 1 << 63 else seed


class DrawState:
    """Per-slot Philox streams (ops/sample.py): seed [S] and counter [S]
    int64 on the device. A slot's draws depend on its seed, its counter
    and the value's index alone; every draw call advances the counter of
    every slot by the rows it drew for it."""

    def __init__(self, seed: torch.Tensor, counter: torch.Tensor):
        self.seed, self.counter = seed, counter

    @classmethod
    def create(cls, n_slots: int, device: str | torch.device = "cpu",
               seeds=0) -> "DrawState":
        """seeds: one int for every slot, or one a slot."""
        seeds = ([seeds] * n_slots if isinstance(seeds, int)
                 else list(seeds))
        return cls(torch.tensor([_int64(s) for s in seeds],
                                dtype=torch.int64, device=device),
                   torch.zeros(n_slots, dtype=torch.int64, device=device))

    def reset_slot(self, slot: int, seed: int) -> None:
        """A new stream for `slot`: its seed, its counter at 0."""
        self.seed[slot] = _int64(seed)
        self.counter[slot] = 0


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


def sample_dist(logits: torch.Tensor, cfg: SamplerConfig,
                state: PenaltyState | None = None,
                vocab_size: int | None = None, eos_id: int | None = None,
                nl_id: int | None = None) -> torch.Tensor:
    """The chain up to the draw: the post-penalty logits (f32 [S, V]) at
    temperature <= 0, whose argmax is the token; else the normalized
    distribution after top-k, temperature and top-p."""
    lf = logits.float()
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        lf = lf.clone()
        lf[..., vocab_size:] = NEG_INF
    if state is not None:
        lf = apply_repeat_penalty(lf, state, cfg, eos_id=eos_id, nl_id=nl_id)
    if cfg.temperature <= 0.0:
        return lf
    lf = apply_top_k(lf, cfg.top_k)
    lf = lf / cfg.temperature
    probs = torch.softmax(lf, dim=-1)
    probs = apply_top_p(probs, cfg.top_p, cfg.min_keep)
    return probs / probs.sum(dim=-1, keepdim=True)


def sample_logits(logits: torch.Tensor, cfg: SamplerConfig,
                  state: PenaltyState | None = None,
                  vocab_size: int | None = None, eos_id: int | None = None,
                  nl_id: int | None = None,
                  draws: DrawState | None = None) -> torch.Tensor:
    """Full chain -> sampled token ids [S] (int64). A sampled chain draws
    from `draws` (its rows split over its slots; default a one-slot
    stream seeded with cfg.seed)."""
    dist = sample_dist(logits, cfg, state, vocab_size, eos_id, nl_id)
    if cfg.temperature <= 0.0:
        return torch.argmax(dist, dim=-1)
    if draws is None:
        draws = DrawState.create(1, dist.device, cfg.seed)
    return categorical_from_dist(dist, draws)


def sample_dist_batched(logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        state: PenaltyState | None = None,
                        penalty_repeat: torch.Tensor | None = None,
                        penalty_freq: torch.Tensor | None = None,
                        penalty_present: torch.Tensor | None = None,
                        max_top_k: int = 64,
                        vocab_size: int | None = None) -> torch.Tensor:
    """Each slot's sampling distribution [S, V] (normalized) after the
    chain penalties -> top-k -> temperature -> top-p; a slot with
    temperature <= 0 gets a one-hot at its post-penalty argmax.

    Penalties count every token of the slot's window: positive logits of
    those tokens are divided by penalty_repeat and negative ones
    multiplied, then lf -= count * penalty_freq + present *
    penalty_present (the OpenAI frequency/presence penalties). top_k <= 0
    means max_top_k."""
    S, V = logits.shape
    lf = logits.float()
    if vocab_size is not None and vocab_size < V:
        col = torch.arange(V, device=lf.device)[None, :]
        lf = torch.where(col < vocab_size, lf, NEG_INF)
    if state is not None and (penalty_repeat is not None
                              or penalty_freq is not None
                              or penalty_present is not None):
        idx = torch.where(state.recent >= 0, state.recent.long(), V)
        counts = torch.zeros(S, V + 1, dtype=torch.float32, device=lf.device)
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
        counts = counts[:, :V]
        present = counts > 0
        if penalty_repeat is not None:
            pr = penalty_repeat[:, None]
            lf = torch.where(present, torch.where(lf > 0, lf / pr, lf * pr),
                             lf)
        if penalty_freq is not None:
            lf = lf - counts * penalty_freq[:, None]
        if penalty_present is not None:
            lf = lf - present.float() * penalty_present[:, None]
    greedy_tok = torch.argmax(lf, dim=-1)

    kmax = min(max_top_k, V)
    kth = torch.topk(lf, kmax, dim=-1).values  # [S, kmax] descending
    k_eff = torch.clamp(torch.where(top_k <= 0, kmax, top_k), 1, kmax)
    thr = torch.gather(kth, 1, (k_eff - 1).long()[:, None])
    lf = torch.where(lf < thr, NEG_INF, lf)

    temp = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(lf / temp, dim=-1)

    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    keep = (csum - sorted_probs) < top_p[:, None]
    keep[:, 0] = True
    pthr = torch.where(keep, sorted_probs, torch.inf).amin(dim=-1,
                                                          keepdim=True)
    probs = torch.where(probs >= pthr, probs, 0.0)
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    onehot = torch.nn.functional.one_hot(greedy_tok, V).float()
    return torch.where(temperature[:, None] <= 0.0, onehot, probs)


def sample_logits_batched(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          draws: DrawState | None,
                          state: PenaltyState | None = None,
                          penalty_repeat: torch.Tensor | None = None,
                          penalty_freq: torch.Tensor | None = None,
                          penalty_present: torch.Tensor | None = None,
                          max_top_k: int = 64,
                          vocab_size: int | None = None) -> torch.Tensor:
    """Per-slot sampling with tensor parameters [S] -> token ids [S]
    (int64). Row i draws from slot i's stream of `draws`; a greedy slot
    (temperature <= 0) has a one-hot distribution, whose draw is its
    argmax. draws None: every slot is greedy, and nothing is drawn."""
    probs = sample_dist_batched(logits, temperature, top_k, top_p, state,
                                penalty_repeat, penalty_freq,
                                penalty_present, max_top_k, vocab_size)
    return categorical_from_dist(probs, draws)


def draft_probs(logits: torch.Tensor, top_k: int, temperature: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The host tree engine's draft sampler: TopK -> Temperature ->
    Softmax over rows [S, V]. Returns (probs f32 [S, k], ids [S, k])."""
    vals, ids = torch.topk(logits.float(), top_k, dim=-1)
    return torch.softmax(vals / max(temperature, 1e-6), dim=-1), ids


def categorical_from_dist(dist: torch.Tensor, draws: DrawState | None
                          ) -> torch.Tensor:
    """One draw per row of the distributions dist [R, V] -> token ids [R]
    (int64), from the streams of `draws` (R / S rows a slot, slot-major).
    A one-hot row (a greedy slot) draws its argmax. draws None: every row
    takes its argmax without a draw."""
    if draws is None:
        return torch.argmax(dist, dim=-1)
    return sample_categorical(dist.float().contiguous(), draws.seed,
                              draws.counter)


def uniform_draws(draws: DrawState | None, rows: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """[rows, n] uniform draws in [0, 1) (rows / S a slot); zeros
    without draws."""
    if draws is None:
        return torch.zeros(rows, n, device=device)
    return sample_uniform(draws.seed, draws.counter, rows, n)


def gumbel_draws(draws: DrawState | None, rows: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """[rows, n] Gumbel(0, 1) draws (rows / S a slot); zeros without
    draws."""
    if draws is None:
        return torch.zeros(rows, n, device=device)
    return sample_gumbel(draws.seed, draws.counter, rows, n)
