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

`flash_decode_paged` is the same attention over the paged pool
(kv/paged.py): the kernel reads logical position t of slot s from pool
page page_table[s, t // page], row t % page; the twin
`flash_decode_paged_reference` gathers the slot views and runs the dense
twin. Unallocated entries (= P) are clipped into the pool in both; only
hidden positions map there. With state=True it returns the merged but
unnormalized softmax partition (o [S, R, D], m [S, R], l [S, R], rows
R = (h, g, tq) with tq minor, the TPU kernel's order), which
`flash_decode_paged_deferred` merges with the partition of a block of
new K/V that is not in the pool yet (plain PyTorch, as the JAX package
computes it in XLA outside its kernel).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF

KERNEL_CHUNK = 64
KERNEL_SPLIT = 256


def _decode_state(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                  vq: torch.Tensor, vs: torch.Tensor,
                  visibility: torch.Tensor, scale: float, chunk: int,
                  split: int | None) -> tuple:
    """The twin's merged, unnormalized partition: (acc f32 [S, Hkv, G, Tq,
    D], m, l f32 [S, Hkv, G, Tq])."""
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
    return acc, m, l


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
    acc, _, l = _decode_state(q, kq, ks, vq, vs, visibility, scale, chunk,
                              split)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, Tq, H * D)


def gather_pages(slab: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Pool slab [P, H, page(, D)] -> per-slot view [S, H, MP * page(, D)]
    through page_table [S, MP] (entries clipped into [0, P))."""
    S, MP = page_table.shape
    pt = page_table.long().clamp(0, slab.shape[0] - 1)
    out = slab[pt].movedim(2, 1)  # [S, H, MP, page(, D)]
    return out.reshape((S, slab.shape[1], MP * slab.shape[2])
                       + tuple(slab.shape[3:]))


def flash_decode_paged_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                 ks_pool: torch.Tensor, v_pool: torch.Tensor,
                                 vs_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 visibility: torch.Tensor, scale: float,
                                 chunk: int = KERNEL_CHUNK,
                                 split: int | None = KERNEL_SPLIT,
                                 state: bool = False):
    """Plain PyTorch twin of the paged kernel: the gathered slot views
    through the dense twin. Pools [P, Hkv, page(, D)], page_table int32
    [S, MP], visibility bool [S, Tq, MP * page]. state=True: (o [S, R, D],
    m [S, R], l [S, R]) unnormalized, R = (h, g, tq)."""
    views = tuple(gather_pages(t, page_table)
                  for t in (k_pool, ks_pool, v_pool, vs_pool))
    if not state:
        return flash_decode_quant_reference(q, *views, visibility, scale,
                                            chunk, split)
    acc, m, l = _decode_state(q, *views, visibility, scale, chunk, split)
    S, D = q.shape[0], q.shape[-1]
    return acc.reshape(S, -1, D), m.reshape(S, -1), l.reshape(S, -1)


def _splits_scratch(L, S: int, Hkv: int, R: int, T: int, D: int,
                    dev: torch.device):
    n_split = L.ps_flash_decode_splits(T)
    m_part = torch.empty(S, Hkv, n_split, R, dtype=torch.float32, device=dev)
    acc_part = torch.empty(S, Hkv, n_split, R, D, dtype=torch.float32,
                           device=dev)
    return m_part, torch.empty_like(m_part), acc_part


def _check_smem(L, dev: torch.device, R: int, Tq: int, T: int, D: int,
                name: str) -> None:
    smem = L.ps_flash_decode_smem(R, Tq, T, D)
    limit = cuda_lib.max_dynamic_smem(dev)
    if smem > limit:
        raise ValueError(f"{name}: G*Tq={R}, T={T}, D={D} needs {smem} bytes "
                         f"of shared memory, the card has {limit}")


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
    R = (H // Hkv) * Tq
    _check_smem(L, dev, R, Tq, T, D, "flash_decode")
    m_part, l_part, acc_part = _splits_scratch(L, S, Hkv, R, T, D, dev)
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


def flash_decode_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            ks_pool: torch.Tensor, v_pool: torch.Tensor,
                            vs_pool: torch.Tensor, page_table: torch.Tensor,
                            visibility: torch.Tensor, scale: float,
                            state: bool = False):
    """Launch csrc/flash_decode.cu in paged mode (one CUDA device); its
    state mode with state=True."""
    dev = q.device
    S, Tq, H, D = q.shape
    if k_pool.dim() != 4:
        raise ValueError(f"k_pool must be [P, Hkv, page, D], got "
                         f"{tuple(k_pool.shape)}")
    P, Hkv, page = k_pool.shape[:3]
    MP = page_table.shape[1]
    T = MP * page
    if H % Hkv or D % 4:
        raise ValueError(f"H={H}, Hkv={Hkv}, D={D}: need H % Hkv == 0 and "
                         f"D % 4 == 0")
    q = q.float().contiguous()
    vis = visibility.contiguous().view(torch.uint8)
    pt = page_table.to(torch.int32).contiguous()
    cuda_lib.require(q, "q", dev, (torch.float32,), (S, Tq, H, D))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        cuda_lib.require(t, name, dev, (torch.int8,), (P, Hkv, page, D))
    for name, t in (("ks_pool", ks_pool), ("vs_pool", vs_pool)):
        cuda_lib.require(t, name, dev, (torch.float32,), (P, Hkv, page))
    cuda_lib.require(pt, "page_table", dev, (torch.int32,), (S, MP))
    cuda_lib.require(vis, "visibility", dev, (torch.uint8,), (S, Tq, T))
    L = cuda_lib.lib()
    R = (H // Hkv) * Tq
    _check_smem(L, dev, R, Tq, T, D, "flash_decode_paged")
    m_part, l_part, acc_part = _splits_scratch(L, S, Hkv, R, T, D, dev)
    if state:
        out = torch.empty(S, H * Tq, D, dtype=torch.float32, device=dev)
        m_out = torch.empty(S, H * Tq, dtype=torch.float32, device=dev)
        l_out = torch.empty_like(m_out)
    else:
        out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
        m_out = l_out = None
    rc = L.ps_flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), ks_pool.data_ptr(),
        v_pool.data_ptr(), vs_pool.data_ptr(), pt.data_ptr(), vis.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), cuda_lib.ptr(m_out), cuda_lib.ptr(l_out), S, Tq, H,
        Hkv, MP, page, P, D, float(scale), cuda_lib.stream(dev))
    name = "flash_decode_paged_state" if state else "flash_decode_paged"
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.check(rc, name)
    return (out, m_out, l_out) if state else out


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       ks_pool: torch.Tensor, v_pool: torch.Tensor,
                       vs_pool: torch.Tensor, page_table: torch.Tensor,
                       visibility: torch.Tensor, scale: float,
                       state: bool = False):
    """q: [S, Tq, H, D]; k_pool/v_pool: [P, Hkv, page, D] int8;
    ks_pool/vs_pool: [P, Hkv, page]; page_table: [S, MP] int32 (P =
    unallocated); visibility: [S, Tq, MP * page] bool.
    Returns [S, Tq, H*D] f32; with state=True the unnormalized partition
    (o [S, R, D], m [S, R], l [S, R]), R = (h, g, tq) with tq minor."""
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k_pool, ks_pool, v_pool,
                                            vs_pool, page_table, visibility,
                                            scale, state=state)
    return flash_decode_paged_cuda(q, k_pool, ks_pool, v_pool, vs_pool,
                                   page_table, visibility, scale, state)


def flash_decode_paged_deferred(q: torch.Tensor, k_pool: torch.Tensor,
                                ks_pool: torch.Tensor, v_pool: torch.Tensor,
                                vs_pool: torch.Tensor,
                                page_table: torch.Tensor,
                                vis_committed: torch.Tensor,
                                knew_q: torch.Tensor, knew_s: torch.Tensor,
                                vnew_q: torch.Tensor, vnew_s: torch.Tensor,
                                intra_vis: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Paged flash-decode with an in-flight block of new K/V that is not
    in the pool yet: the committed pages through the state mode, the new
    block (knew_q/vnew_q int8 [S, Hkv, Tq, D], scales [S, Hkv, Tq],
    intra_vis bool [S, Tq, Tq]) as a second softmax partition, merged as
    the JAX package merges them. A partition that a row does not see at
    all (m <= -1e30 / 2) weighs 0. Returns f32 [S, Tq, H * D]."""
    S, Tq, H, D = q.shape
    Hkv = k_pool.shape[1]
    G = H // Hkv
    o1, m1, l1 = flash_decode_paged(q, k_pool, ks_pool, v_pool, vs_pool,
                                    page_table, vis_committed, scale,
                                    state=True)
    qg = q.reshape(S, Tq, Hkv, G, D).to(torch.bfloat16).float()
    sn = torch.einsum("sqhgd,shkd->shgqk", qg, knew_q.float())
    sn = sn * (knew_s[:, :, None, None, :] * scale)
    sn = torch.where(intra_vis[:, None, None], sn, NEG_INF)
    m2 = sn.amax(dim=-1)  # [S, Hkv, G, Tq]
    p2 = torch.exp(sn - m2[..., None])
    p2 = torch.where(sn > NEG_INF / 2, p2, 0.0)
    l2 = p2.sum(dim=-1)
    pf = (p2 * vnew_s[:, :, None, None, :]).to(torch.bfloat16).float()
    o2 = torch.einsum("shgqk,shkd->shgqd", pf, vnew_q.float())
    m2, l2, o2 = m2.reshape(S, -1), l2.reshape(S, -1), o2.reshape(S, -1, D)
    m = torch.maximum(m1, m2)
    a1 = torch.where(m1 > NEG_INF / 2, torch.exp(m1 - m), 0.0)
    a2 = torch.where(m2 > NEG_INF / 2, torch.exp(m2 - m), 0.0)
    l = l1 * a1 + l2 * a2
    o = o1 * a1[..., None] + o2 * a2[..., None]
    out = o / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(S, Hkv, G, Tq, D).permute(0, 3, 1, 2, 4).reshape(
        S, Tq, H * D)
