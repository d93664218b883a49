"""Perplexity evaluation (the JAX package's tools/perplexity.py).

The same algorithm: slide over the token stream in chunks of batch_size,
score each next token by its log-softmax probability, ppl = exp(-sum log
p / n), skipping the first `warmup_batches * batch_size` predictions.
Each chunk is one teacher-forced forward with logits_mode="all" over a
one-slot int8 cache: chunks of more than 16 rows run the prefill kernels
(flash-prefill, the prefill GEMM for the projections and the lm_head), a
last chunk of at most 16 rows the decode kernels. The log-softmax and
the gather of each next token's log-probability run where the logits
are, in f64, so the host reads T floats a chunk, not [T, vocab] logits.

  python -m powerserve_tpu_torch perplexity -d <model dir> -p corpus.txt
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..kv.cache import KVCache
from ..models.llama import LlamaModel


class PerplexityCalculator:
    """Streaming accumulator (reference perplexity/main.cpp:13-47)."""

    def __init__(self, warmup_tokens: int = 0):
        self.warmup = warmup_tokens
        self.seen = 0
        self.log_prob_sum = 0.0
        self.count = 0

    def update(self, logits: np.ndarray, next_tokens: np.ndarray) -> None:
        """logits [T, V] for positions whose next token is next_tokens [T]."""
        logits = np.asarray(logits, np.float64)
        m = logits.max(axis=-1, keepdims=True)
        logz = m[:, 0] + np.log(np.exp(logits - m).sum(axis=-1))
        logp = logits[np.arange(len(next_tokens)), next_tokens] - logz
        self.add_log_probs(logp)

    def add_log_probs(self, logp: np.ndarray) -> None:
        """The log-probabilities [T] of T next tokens, in order."""
        for lp in logp:
            self.seen += 1
            if self.seen <= self.warmup:
                continue
            self.log_prob_sum += lp
            self.count += 1

    @property
    def ppl(self) -> float:
        if self.count == 0:
            return float("inf")
        return math.exp(-self.log_prob_sum / self.count)


def next_token_log_probs(logits: torch.Tensor,
                         next_tokens: torch.Tensor) -> torch.Tensor:
    """f64 [T]: log-softmax of logits [T, V] at next_tokens [T], by
    PerplexityCalculator.update's formula, on the logits' device."""
    logits = logits.double()
    m = logits.max(dim=-1, keepdim=True).values
    logz = m[:, 0] + (logits - m).exp().sum(dim=-1).log()
    return logits.gather(1, next_tokens.long()[:, None])[:, 0] - logz


@torch.no_grad()
def token_log_probs(model: LlamaModel, token_ids: list[int],
                    batch_size: int = 32, max_seq: int = 0) -> np.ndarray:
    """f64 [n - 1]: the log-probability of each token after the first
    of the corpus (its first min(len, max_seq) tokens) given the ones
    before it, by batched teacher-forced forwards on the model's device
    (reference main.cpp:63-139)."""
    llm = model.llm
    dev = model.out_norm.device
    max_seq = max_seq or llm.seq_len
    n = min(len(token_ids), max_seq)
    toks = torch.as_tensor(np.asarray(token_ids[:n], np.int32), device=dev)
    kv = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                        llm.head_size, device=dev)
    out = []
    for off in range(0, n - 1, batch_size):
        part = toks[off:off + batch_size]
        T = len(part)
        positions = torch.arange(off, off + T, device=dev)[None, :]
        logits = model(kv, part[None, :], positions, logits_mode="all")
        # prediction at position off+i scores token off+i+1
        valid = min(T, n - 1 - off)
        logp = next_token_log_probs(logits[0, :valid, :llm.vocab_size],
                                    toks[off + 1:off + 1 + valid])
        del logits
        out.append(logp.cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def compute_perplexity(model: LlamaModel, token_ids: list[int],
                       batch_size: int = 32, max_seq: int = 0,
                       warmup_batches: int = 1) -> float:
    """exp(-mean log p) over the corpus's predictions after the first
    warmup_batches * batch_size (PPL_START_ID, main.cpp:23)."""
    calc = PerplexityCalculator(warmup_tokens=warmup_batches * batch_size)
    calc.add_log_probs(token_log_probs(model, token_ids, batch_size,
                                       max_seq))
    return calc.ppl


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch perplexity")
    ap.add_argument("-d", "--model-dir", required=True)
    ap.add_argument("-p", "--prompt-file", required=True)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)

    from ..models.loader import load_gguf_model
    from ..tokenizer import Tokenizer

    _, model = load_gguf_model(args.model_dir, device=args.device)
    tok = Tokenizer.from_model_dir(args.model_dir)
    ids = tok.tokenize(Path(args.prompt_file).read_text())
    ppl = compute_perplexity(model, ids, args.batch_size, args.max_seq)
    print(json.dumps({"perplexity": ppl, "n_tokens": len(ids)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
