"""Flash-prefill attention over the int8 KV cache.

Prefill-shape attention (many query rows) reading the quantized cache
directly, with the visibility computed from two facts of a prefill
batch instead of a shipped [S, Tq, T] mask:

  vis[s, i, t] = cache_mask[s, t]          (committed before this batch)
               | (0 <= t - start[s] <= i)  (the batch itself: row i sits
                                            at start[s] + i, causal)

where start[s] is the slot's first write position (positions[:, 0]) and
i the row's index in the batch. Padded -1 lanes sit at the end of a
batch and inactive slots have start = -1: their rows see positions
nothing committed, and nothing reads those rows.

Same math as ops/attention.py::gqa_attention_quant, computed with an
online softmax over T chunks:

  s[r, t] = (bf16(q[r]) . kq[t]) * (ks[t] * scale), -1e30 where hidden
  per chunk: m' = max(m, max_t s); alpha = exp(m - m'); p = exp(s - m')
             l = l * alpha + sum p; acc = acc * alpha + bf16(p * vs) . vq
  out = acc / (l > 0 ? l : 1)

`flash_prefill_quant` launches csrc/flash_prefill.cu for CUDA tensors
and runs the plain twin `flash_prefill_quant_reference` for CPU tensors.
The kernel cuts the batch into query blocks of bq rows
(`kernel_query_block`); each (slot, kv head, query block) walks its
KERNEL_CHUNK-token chunks [0, end) (1 + the last position one of its rows
sees; all of T where a row sees nothing: `kernel_walk`) with one online
softmax. The twin walks the same chunks by default, and takes any other
chunk and query block, so the CPU tests can also match the JAX kernel's
chunking exactly.

A row that sees no position at all averages V over the T positions (the
masked scores are a finite -1e30, as in the JAX reference); the JAX
Pallas kernel averages over T rounded up to its chunk instead. Only
garbage rows (padded lanes, inactive slots) can see nothing.

The state mode (state=True, a sequence-parallel rank's share:
ops/attention.py gqa_attention_quant_sp) skips the normalization and
returns the partition (o [S, R, D], m [S, R], l [S, R]), R = (h, g, i)
with i minor, as flash-decode's state modes do. Its key offset t0 makes
visibility that of global positions: cache position t is global position
t0 + t, start is global, so the batch's interval begins at cache position
start - t0 (before 0, or past T, when the chunk begins or ends on another
rank's slice). A unit walks only the chunks some row sees, and a row that
sees nothing returns m = -1e30, l = 0, o = 0.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF

KERNEL_CHUNK = 64
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_GROUP = 8  # query heads per kv head


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def kernel_query_block(Tq: int, G: int) -> int:
    """The kernel's query block bq: G * bq <= 128 rows, eight warps where
    G divides 8."""
    return min(16 * max(1, 8 // G), 16 * _ceil(Tq, 16))


def prefill_visibility(cache_mask: torch.Tensor, start: torch.Tensor,
                       Tq: int) -> torch.Tensor:
    """The kernel's visibility as a tensor: bool [S, Tq, T]."""
    T = cache_mask.shape[1]
    dev = cache_mask.device
    off = (torch.arange(T, device=dev)[None, None, :]
           - start.long()[:, None, None])
    rows = torch.arange(Tq, device=dev)[None, :, None]
    return cache_mask[:, None, :] | ((off >= 0) & (off <= rows))


def kernel_walk(cache_mask: torch.Tensor, start: torch.Tensor, Tq: int,
                bq: int, chunk: int = KERNEL_CHUNK,
                state: bool = False) -> torch.Tensor:
    """How far each (slot, query block) walks, int64 [S, Tq / bq]: chunks
    [0, n_end), up to 1 + the last position one of its rows sees, all of
    T where a row sees nothing (not in the state mode)."""
    T = cache_mask.shape[1]
    dev = cache_mask.device
    last = torch.where(cache_mask.bool(), torch.arange(1, T + 1, device=dev),
                       0).amax(dim=-1)[:, None]
    first = torch.arange(0, Tq, bq, device=dev)[None, :]
    q_last = (first + bq).clamp(max=Tq) - 1
    st = start.long().to(dev)[:, None]
    lo, hi = st.clamp(min=0), (st + q_last).clamp(max=T - 1)
    end = torch.maximum(last, torch.where(lo <= hi, hi + 1, 0))
    all_see = (last > 0) | ((st < T) & (st + first >= 0)) | state
    return torch.where(all_see, (end + chunk - 1) // chunk, _ceil(T, chunk))


def flash_prefill_quant_reference(q: torch.Tensor, kq: torch.Tensor,
                                  ks: torch.Tensor, vq: torch.Tensor,
                                  vs: torch.Tensor, cache_mask: torch.Tensor,
                                  start: torch.Tensor, scale: float,
                                  qb: int | None = None,
                                  chunk: int = KERNEL_CHUNK,
                                  state: bool = False, t0: int = 0):
    """Plain PyTorch twin of the kernel. q [S, Tq, H, D]; kq/vq int8
    [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T]; cache_mask bool [S, T];
    start int [S]. Query blocks of qb rows (None: the kernel's), each
    walking its chunks [0, n_end) (kernel_walk). Returns f32
    [S, Tq, H * D]; with state=True the unnormalized partition (o
    [S, R, D], m [S, R], l [S, R]), R = (h, g, i), start global and the
    cache's first position t0."""
    S, Tq, H, D = q.shape
    Hkv, T = kq.shape[1], kq.shape[2]
    G = H // Hkv
    dev = q.device
    if qb is None:
        qb = kernel_query_block(Tq, G)
    start = start.long() - t0
    n_end = kernel_walk(cache_mask, start, Tq, qb, chunk, state)
    qg = (q.reshape(S, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .to(torch.bfloat16).float())  # [S, Hkv, G, Tq, D]
    neg = torch.tensor(NEG_INF, device=dev)
    st = start.long()[:, None, None]
    out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
    states = []
    for b, q0 in enumerate(range(0, Tq, qb)):
        q1 = min(Tq, q0 + qb)
        rows = torch.arange(q0, q1, device=dev)[None, :, None]
        qq = qg[:, :, :, q0:q1]
        shape = (S, Hkv, G, q1 - q0)
        m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(shape + (D,), dtype=torch.float32, device=dev)
        ends = n_end[:, b]
        for c in range(int(ends.max())):
            t0, t1 = c * chunk, min(T, (c + 1) * chunk)
            live = (c < ends)[:, None, None, None]
            off = torch.arange(t0, t1, device=dev)[None, None, :] - st
            vis = cache_mask[:, None, t0:t1] | ((off >= 0) & (off <= rows))
            s = torch.einsum("shgqd,shcd->shgqc", qq, kq[:, :, t0:t1].float())
            s = s * (ks[:, :, None, None, t0:t1] * scale)
            s = torch.where(vis[:, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            pf = (p * vs[:, :, None, None, t0:t1]).to(torch.bfloat16).float()
            l = torch.where(live, l * alpha + p.sum(dim=-1), l)
            acc = torch.where(
                live[..., None], acc * alpha[..., None] + torch.einsum(
                    "shgqc,shcd->shgqd", pf, vq[:, :, t0:t1].float()), acc)
            m = torch.where(live, m_new, m)
        if state:
            states.append((acc, m, l))
            continue
        o = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(S, q1 - q0, H * D)
    if state:
        from .flash_decode import _state_rows

        return _state_rows(*(torch.cat(parts, dim=3)
                             for parts in zip(*states)))
    return out


def flash_prefill_cuda(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor,
                       cache_mask: torch.Tensor, start: torch.Tensor,
                       scale: float, state: bool = False, t0: int = 0):
    """Launch csrc/flash_prefill.cu (all operands on one CUDA device); its
    state mode with state=True (key offset t0)."""
    dev = q.device
    S, Tq, H, D = q.shape
    if kq.dim() != 4:
        raise ValueError(f"kq must be [S, Hkv, T, D], got {tuple(kq.shape)}")
    Hkv, T = kq.shape[1], kq.shape[2]
    if H % Hkv or H // Hkv > KERNEL_MAX_GROUP or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"H={H}, Hkv={Hkv}, D={D}: the kernel takes "
                         f"H % Hkv == 0, H / Hkv <= {KERNEL_MAX_GROUP} and "
                         f"D in {KERNEL_HEAD_DIMS}")
    q = q.float().contiguous()
    mask = cache_mask.contiguous().view(torch.uint8)
    start = start.to(torch.int32).contiguous()
    cuda_lib.require(q, "q", dev, (torch.float32,), (S, Tq, H, D))
    for name, t in (("kq", kq), ("vq", vq)):
        cuda_lib.require(t, name, dev, (torch.int8,), (S, Hkv, T, D))
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("ks", ks), ("vs", vs)):
        cuda_lib.require(t, name, dev, (torch.float32,), (S, Hkv, T))
    cuda_lib.require(mask, "cache_mask", dev, (torch.uint8,), (S, T))
    cuda_lib.require(start, "start", dev, (torch.int32,), (S,))
    L = cuda_lib.lib()
    smem = L.ps_flash_prefill_smem(T, D)
    limit = cuda_lib.max_dynamic_smem(dev)
    if smem > limit:
        raise ValueError(f"flash_prefill: T={T}, D={D} needs {smem} bytes of "
                         f"shared memory, the card has {limit}")
    if state:
        out = torch.empty(S, H * Tq, D, dtype=torch.float32, device=dev)
        m_out = torch.empty(S, H * Tq, dtype=torch.float32, device=dev)
        l_out = torch.empty_like(m_out)
    else:
        out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
        m_out = l_out = None
    rc = L.ps_flash_prefill(q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                            vq.data_ptr(), vs.data_ptr(), mask.data_ptr(),
                            start.data_ptr(), out.data_ptr(),
                            cuda_lib.ptr(m_out), cuda_lib.ptr(l_out), S, Tq,
                            H, Hkv, T, D, int(t0), float(scale),
                            kernel_query_block(Tq, H // Hkv),
                            cuda_lib.stream(dev))
    name = "flash_prefill_state" if state else "flash_prefill"
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.check(rc, name)
    return (out, m_out, l_out) if state else out


def flash_prefill_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                        vq: torch.Tensor, vs: torch.Tensor,
                        cache_mask: torch.Tensor, start: torch.Tensor,
                        scale: float, state: bool = False, t0: int = 0):
    """q: [S, Tq, H, D]; kq/vq: [S, Hkv, T, D] int8; ks/vs: [S, Hkv, T];
    cache_mask: [S, T] bool (before this batch's advance); start: [S]
    (positions[:, 0]). Returns [S, Tq, H*D] f32; with state=True the
    unnormalized partition (o [S, R, D], m [S, R], l [S, R]), R = (h, g,
    i), over a cache whose position t is global position t0 + t."""
    if q.device.type == "cpu":
        return flash_prefill_quant_reference(q, kq, ks, vq, vs, cache_mask,
                                             start, scale, state=state,
                                             t0=t0)
    return flash_prefill_cuda(q, kq, ks, vq, vs, cache_mask, start, scale,
                              state, t0)
