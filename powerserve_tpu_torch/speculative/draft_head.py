"""Factored (low-rank) draft logits head.

A draft pays a full [dim, vocab] quantized read of its lm_head for every
drafted token. This module factors the lm_head once at load time,

    logits_draft = (xh @ U) @ V,   U [dim, r],  V [r, vocab]

by randomized SVD (Halko et al. 2011), as the JAX package's
speculative/draft_head.py does: the same sketch matrix (drawn with
numpy.random.default_rng(seed)), the dequantized lm_head kept on the
device, the QR of the [dim, r + p] range and the eigh of the
[r + p, r + p] Gram matrix on the host, V requantized to int8 per-32
blocks and U quantized as Q8_0. A LlamaModel with lm_head_lr = (U, V)
runs it as norm -> U, then V with the argmax (ops/fused.py).

The emitted stream does not change: greedy acceptance compares drafts
with the target's argmax, and speculative sampling accepts with
p / q for the q the draft actually sampled from; only acceptance may
drop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.gguf import GGMLType
from ..core.quant import QK
from ..ops.qmatmul import QLinear, dequant

__all__ = ["make_draft_head"]

# columns of the sketch past the rank, and its seed (the JAX defaults)
OVERSAMPLE = 32
SEED = 0


@torch.no_grad()
def make_draft_head(lm_head: QLinear, rank: int = 512
                    ) -> tuple[QLinear, QLinear]:
    """Factor a [dim, vocab] QLinear into (U [dim, r], V [r, vocab]) on
    the lm_head's device. rank must be a multiple of 32 (V's int8
    per-block scales)."""
    if rank % QK:
        raise ValueError(f"rank {rank} must be a multiple of {QK}")
    dev = lm_head.q.device
    vocab = lm_head.out_features
    r, p = rank, OVERSAMPLE
    rng = np.random.default_rng(SEED)
    sketch = (rng.standard_normal((vocab, r + p)).astype(np.float32)
              / np.sqrt(vocab)).astype(np.float32)
    w = dequant(lm_head)  # [dim, vocab] f32, stays on the device
    y = (w @ torch.from_numpy(sketch).to(dev)).cpu().numpy()  # [dim, r+p]
    q, _ = np.linalg.qr(y)
    qd = torch.from_numpy(q.astype(np.float32)).to(dev)
    b = qd.T @ w  # [r+p, vocab]
    c = (b @ b.T).cpu().numpy()
    # B = Ub S Vt, so C = B B^T = Ub S^2 Ub^T (eigh ascending: flip)
    _, evecs = np.linalg.eigh(c)
    ub = np.ascontiguousarray(evecs[:, ::-1][:, :r])  # [r+p, r]
    u = (q @ ub).astype(np.float32)  # [dim, r]
    v = torch.from_numpy(ub.astype(np.float32)).to(dev).T @ b  # [r, vocab]
    del w, b
    # symmetric int8 per 32 rows of V
    vb = v.reshape(r // QK, QK, vocab)
    s = vb.abs().amax(dim=1) / 127.0  # [r/32, vocab]
    qi = torch.round(vb / torch.clamp(s, min=1e-12)[:, None, :])
    qi = torch.clamp(qi, -127, 127).to(torch.int8).reshape(r, vocab)
    v_lin = QLinear(qi, s.float(), None, packed=False, unsigned=False,
                    in_features=r, out_features=vocab)
    return QLinear.from_float(u, GGMLType.Q8_0, device=dev), v_lin
