"""Flash-decode attention over the int8 KV cache.

Decode-shape attention (small Tq) reading the quantized cache directly,
with the per-token scales folded into scores and probabilities — the
same math as ops/attention.py::gqa_attention_quant, computed with an
online softmax over T chunks:

  s[r, t] = (bf16(q[r]) . kq[t]) * (ks[t] * scale), -1e30 where hidden
  per split of T, from (m, l, acc) = (-1e30, 0, 0), per chunk:
             m' = max(m, max_t s); alpha = exp(m - m'); p = exp(s - m')
             l = l * alpha + sum p; acc = acc * alpha + bf16(p * vs) . vq
  merge the splits in order with weights exp(m_i - max_i m_i);
  out = acc / (l > 0 ? l : 1)

`flash_decode_quant` launches csrc/flash_decode.cu for CUDA tensors and
runs the plain twin `flash_decode_quant_reference` (same chunks and
splits) for CPU tensors. The kernel stages KERNEL_CHUNK tokens at a time
and gives each KERNEL_SPLIT tokens of T a block of their own; the plain
twin takes any chunk and split (split=None: one split), so the CPU tests
can also match the JAX kernel's 512-token chunks exactly.

A row that sees no position at all averages V over the T positions (the
masked scores are a finite -1e30, as in the JAX reference); the JAX
Pallas kernel averages over T rounded up to its chunk instead.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF

KERNEL_CHUNK = 64
KERNEL_SPLIT = 256


def flash_decode_quant_reference(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, visibility: torch.Tensor,
                                 scale: float, chunk: int = KERNEL_CHUNK,
                                 split: int | None = KERNEL_SPLIT
                                 ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel. q [S, Tq, H, D]; kq/vq int8
    [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T]; visibility bool [S, Tq, T].
    Returns f32 [S, Tq, H * D]."""
    S, Tq, H, D = q.shape
    Hkv, T = kq.shape[1], kq.shape[2]
    G = H // Hkv
    dev = q.device
    qg = (q.reshape(S, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .to(torch.bfloat16).float())  # [S, Hkv, G, Tq, D]
    neg = torch.tensor(NEG_INF, device=dev)
    parts = []
    for s0 in range(0, T, split or T):
        m = torch.full((S, Hkv, G, Tq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((S, Hkv, G, Tq), dtype=torch.float32, device=dev)
        acc = torch.zeros((S, Hkv, G, Tq, D), dtype=torch.float32, device=dev)
        for t0 in range(s0, min(T, s0 + (split or T)), chunk):
            t1 = min(T, t0 + chunk)
            s = torch.einsum("shgqd,shcd->shgqc", qg, kq[:, :, t0:t1].float())
            s = s * (ks[:, :, None, None, t0:t1] * scale)
            s = torch.where(visibility[:, None, None, :, t0:t1], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pf = (p * vs[:, :, None, None, t0:t1]).to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "shgqc,shcd->shgqd", pf, vq[:, :, t0:t1].float())
            m = m_new
        parts.append((m, l, acc))
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w[..., None]
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, Tq, H * D)


def flash_decode_cuda(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor,
                      visibility: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch csrc/flash_decode.cu (all operands on one CUDA device)."""
    dev = q.device
    S, Tq, H, D = q.shape
    if kq.dim() != 4:
        raise ValueError(f"kq must be [S, Hkv, T, D], got {tuple(kq.shape)}")
    Hkv, T = kq.shape[1], kq.shape[2]
    if H % Hkv or D % 4:
        raise ValueError(f"H={H}, Hkv={Hkv}, D={D}: need H % Hkv == 0 and "
                         f"D % 4 == 0")
    q = q.float().contiguous()
    vis = visibility.contiguous().view(torch.uint8)
    cuda_lib.require(q, "q", dev, (torch.float32,), (S, Tq, H, D))
    for name, t in (("kq", kq), ("vq", vq)):
        cuda_lib.require(t, name, dev, (torch.int8,), (S, Hkv, T, D))
    for name, t in (("ks", ks), ("vs", vs)):
        cuda_lib.require(t, name, dev, (torch.float32,), (S, Hkv, T))
    cuda_lib.require(vis, "visibility", dev, (torch.uint8,), (S, Tq, T))
    L = cuda_lib.lib()
    smem = L.ps_flash_decode_smem((H // Hkv) * Tq, Tq, T, D)
    limit = cuda_lib.max_dynamic_smem(dev)
    if smem > limit:
        raise ValueError(f"flash_decode: G*Tq={(H // Hkv) * Tq}, T={T}, D={D} "
                         f"needs "
                         f"{smem} bytes of shared memory, the card has {limit}")
    R = (H // Hkv) * Tq
    n_split = L.ps_flash_decode_splits(T)
    m_part = torch.empty(S, Hkv, n_split, R, dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty(S, Hkv, n_split, R, D, dtype=torch.float32,
                           device=dev)
    out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
    rc = L.ps_flash_decode(q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                           vq.data_ptr(), vs.data_ptr(), vis.data_ptr(),
                           m_part.data_ptr(), l_part.data_ptr(),
                           acc_part.data_ptr(), out.data_ptr(), S, Tq, H, Hkv,
                           T, D, float(scale), cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["flash_decode"] += 1
    cuda_lib.check(rc, "flash_decode")
    return out


def flash_decode_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor,
                       visibility: torch.Tensor, scale: float,
                       chunk: int = KERNEL_CHUNK,
                       split: int | None = KERNEL_SPLIT) -> torch.Tensor:
    """q: [S, Tq, H, D]; kq/vq: [S, Hkv, T, D] int8; ks/vs: [S, Hkv, T];
    visibility: [S, Tq, T] bool. Returns [S, Tq, H*D] f32."""
    if q.device.type == "cpu":
        return flash_decode_quant_reference(q, kq, ks, vq, vs, visibility,
                                            scale, chunk, split)
    if (chunk, split) != (KERNEL_CHUNK, KERNEL_SPLIT):
        raise ValueError(f"the kernel stages {KERNEL_CHUNK}-token chunks in "
                         f"{KERNEL_SPLIT}-token splits, got {chunk}, {split}")
    return flash_decode_cuda(q, kq, ks, vq, vs, visibility, scale)
