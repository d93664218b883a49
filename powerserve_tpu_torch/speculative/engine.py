"""Speculation statistics, shared by the chain engine, `run` and the
scheduler (the JAX package's speculative/engine.py SpecStats; its host
tree engine is not ported)."""

from __future__ import annotations

from dataclasses import dataclass


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
