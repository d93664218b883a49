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

The visibility comes from the cache's mask [S, T] and the new rows'
positions [S, Tq]: row tq sees t when mask[s, t] is set or some j <= tq
has positions[s, j] == t (ops/attention.py::build_visibility with its
causal intra mask; -1 and positions >= T match nothing). Without
positions (the state mode's committed part) the mask alone. The tree
mode takes key positions [S, J] (J <= MAX_KEYS) and one bit row per
query, `bits` int32 [Tq] (pack_intra of an intra mask [Tq, J]): row tq
sees t when mask[s, t] is set or some key j with bit j of bits[tq] has
positions[s, j] == t. A token tree's verify passes its nodes' positions
and ancestor rows, a draft level all nodes' positions and its own rows'
ancestors, with the mask as it was before the tree. The causal rule is
the tree mode with lower-triangular rows and J = Tq (the same bits).

`flash_decode_quant` launches csrc/flash_decode.cu for CUDA tensors and
runs the plain twin `flash_decode_quant_reference` for CPU tensors; the
twin builds the visibility and runs `flash_decode_visibility_reference`
over it. The kernel walks each slot's positions up to the last one a row
sees, in KERNEL_CHUNK-token steps, each warp a range of them with its own
online softmax (`kernel_walk`); the twin walks the same by default and
takes any other chunk and split (all of T, one split: split=T), so the
CPU tests can also match the JAX kernel's 512-token chunks exactly.

A row that sees no position at all averages V over the T positions (the
masked scores are a finite -1e30, as in the JAX reference); the JAX
Pallas kernel averages over T rounded up to its chunk instead.

The dense state mode (`flash_decode_quant(..., state=True, t0=)`, a
sequence-parallel rank's share: ops/attention.py gqa_attention_quant_sp)
returns the unnormalized partition over the cache's positions as the
paged state mode below does, with the kernel's walk of a state (no walk
of all of T). Its key offset t0 says where the cache's positions start:
local position t is global position t0 + t, and the new rows' positions
are global (positions - t0 match local positions; the others match
nothing), the tree mode's key positions too (a token tree's verify or
draft level over a rank's slice; its launches count as
flash_decode_state_tree). A row that sees no position returns m = -1e30,
l = 0 and o = 0, in both state modes, so a merge weighs it 0 whatever it
does.

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

import ctypes

import torch

from . import cuda_lib
from .attention import NEG_INF, build_visibility

# the kernel's step (tokens) and bounds (csrc/flash_decode.cu)
KERNEL_CHUNK = 16
_MAX_SPLITS = 8
_TARGET_BLOCKS = 128
MAX_ROWS = 128  # G * Tq query rows per kv head
MAX_HEAD = 128
MAX_KEYS = 32  # key positions of the tree mode (bits in a row)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def kernel_walk(visibility: torch.Tensor, Hkv: int, G: int,
                state: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """How csrc/flash_decode.cu walks each slot, int64 [S] each: (end,
    split). It walks positions [0, end), 1 + the last one any row sees
    (all of T in the normalized output where a row sees nothing), in
    online-softmax states of `split` tokens, each a warp's: a block holds
    eight token groups up to 32 rows (G * Tq; a warp takes both 16-row
    tiles of 17 to 32), two up to 64, else one; a (slot, kv head) takes
    128 // (S * Hkv) blocks, 1 to 8."""
    S, Tq, T = visibility.shape
    dev = visibility.device
    end = torch.where(visibility.any(dim=1),
                      torch.arange(1, T + 1, device=dev), 0).amax(dim=-1)
    if not state:
        end = torch.where(visibility.any(dim=-1).all(dim=-1), end, T)
    n_mt = _ceil(G * Tq, 16)
    groups = 8 if n_mt <= 2 else 2 if n_mt <= 4 else 1
    most = min(_MAX_SPLITS, max(1, _TARGET_BLOCKS // (S * Hkv)))
    widest = KERNEL_CHUNK * _ceil(_ceil(T, KERNEL_CHUNK), most * groups)
    per = _ceil(T, groups * widest) * groups  # splits x token groups
    steps = (end + KERNEL_CHUNK - 1) // KERNEL_CHUNK
    split = KERNEL_CHUNK * ((steps + per - 1) // per)
    return end, torch.where(end > 0, split, KERNEL_CHUNK)


def pack_intra(intra: torch.Tensor) -> torch.Tensor:
    """An intra mask [Tq, J] bool (J <= MAX_KEYS) as the kernel's bit rows
    int32 [Tq]: bit j of row tq is intra[tq, j]."""
    J = intra.shape[1]
    if J > MAX_KEYS:
        raise ValueError(f"{J} keys: the tree mode takes at most {MAX_KEYS}")
    w = 2 ** torch.arange(J, dtype=torch.int64, device=intra.device)
    v = (intra.long() * w).sum(dim=1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack_bits(bits: torch.Tensor, J: int) -> torch.Tensor:
    """The kernel's bit rows int32 [Tq] as an intra mask [Tq, J] bool."""
    j = torch.arange(J, device=bits.device)
    return (bits.long()[:, None] >> j[None, :]) & 1 == 1


def decode_visibility(mask: torch.Tensor, positions: torch.Tensor | None,
                      Tq: int, bits: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The kernel's visibility [S, Tq, T] bool: build_visibility(mask,
    positions) (causal, or the tree mode's rows `bits` over the keys
    positions [S, J]), or the mask alone for every row without
    positions."""
    if positions is None:
        S, T = mask.shape
        return mask.bool()[:, None, :].expand(S, Tq, T)
    intra = None if bits is None else unpack_bits(bits, positions.shape[1])
    return build_visibility(mask.bool(), positions.long(), intra)


def _decode_state(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                  vq: torch.Tensor, vs: torch.Tensor,
                  visibility: torch.Tensor, scale: float, chunk: int,
                  split, end: torch.Tensor | None = None) -> tuple:
    """The twin's merged, unnormalized partition: (acc f32 [S, Hkv, G, Tq,
    D], m, l f32 [S, Hkv, G, Tq]). Walks positions [0, end) (end [S],
    default all of T) in chunks, with one online softmax per `split`
    tokens (an int, None: one, or [S] per slot), merged in order."""
    S, Tq, H, D = q.shape
    Hkv, T = kq.shape[1], kq.shape[2]
    G = H // Hkv
    dev = q.device
    qg = (q.reshape(S, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .to(torch.bfloat16).float())  # [S, Hkv, G, Tq, D]
    neg = torch.tensor(NEG_INF, device=dev)
    split = torch.as_tensor(T if split is None else split,
                            device=dev).expand(S)
    end = (torch.full((S,), T, device=dev) if end is None
           else end.to(dev))
    per_slot = lambda t: t[:, None, None, None]  # noqa: E731
    shape = (S, Hkv, G, Tq)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = torch.zeros(shape + (D,), dtype=torch.float32, device=dev)
    mm, lm, am = torch.full_like(m, float("-inf")), l, acc  # merged

    def fold(sel):  # merge the running states of slots `sel`, reset them
        nonlocal m, l, acc, mm, lm, am
        top = torch.maximum(mm, m)
        wa, wb = torch.exp(mm - top), torch.exp(m - top)
        k = per_slot(sel)
        lm = torch.where(k, lm * wa + l * wb, lm)
        am = torch.where(k[..., None], am * wa[..., None]
                         + acc * wb[..., None], am)
        mm = torch.where(k, top, mm)
        m = torch.where(k, neg, m)
        l = torch.where(k, 0.0, l)
        acc = torch.where(k[..., None], 0.0, acc)

    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        live = t0 < end
        if not bool(live.any()):
            break
        fold(live & (torch.remainder(torch.full_like(split, t0), split) == 0)
             & (t0 > 0))
        s = torch.einsum("shgqd,shcd->shgqc", qg, kq[:, :, t0:t1].float())
        s = s * (ks[:, :, None, None, t0:t1] * scale)
        s = torch.where(visibility[:, None, None, :, t0:t1], s, neg)
        walked = torch.arange(t0, t1, device=dev)[None, :] < end[:, None]
        s = torch.where(walked[:, None, None, None, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        pf = (p * vs[:, :, None, None, t0:t1]).to(torch.bfloat16).float()
        k = per_slot(live)
        l = torch.where(k, l * alpha + p.sum(dim=-1), l)
        acc = torch.where(k[..., None], acc * alpha[..., None] + torch.einsum(
            "shgqc,shcd->shgqd", pf, vq[:, :, t0:t1].float()), acc)
        m = torch.where(k, m_new, m)
    fold(torch.ones(S, dtype=torch.bool, device=dev))
    return am, mm, lm


def _state_rows(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                ) -> tuple:
    """A state partition (acc [S, Hkv, G, Tq, D], m, l [S, Hkv, G, Tq]) as
    the kernel writes it: (o [S, R, D], m [S, R], l [S, R]), R = (h, g,
    tq) with tq minor, and a row that saw no position (m <= -1e30 / 2)
    as m = -1e30, l = 0, o = 0."""
    S, D = acc.shape[0], acc.shape[-1]
    seen = m > NEG_INF / 2
    o = torch.where(seen[..., None], acc, 0.0).reshape(S, -1, D)
    return (o, torch.where(seen, m, NEG_INF).reshape(S, -1),
            torch.where(seen, l, 0.0).reshape(S, -1))


def flash_decode_visibility_reference(q: torch.Tensor, kq: torch.Tensor,
                                      ks: torch.Tensor, vq: torch.Tensor,
                                      vs: torch.Tensor,
                                      visibility: torch.Tensor, scale: float,
                                      chunk: int = KERNEL_CHUNK, split=None,
                                      end: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """Plain PyTorch twin over a visibility. q [S, Tq, H, D]; kq/vq int8
    [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T]; visibility bool [S, Tq, T];
    split and end as _decode_state's. Returns f32 [S, Tq, H * D]."""
    S, Tq, H, D = q.shape
    acc, _, l = _decode_state(q, kq, ks, vq, vs, visibility, scale, chunk,
                              split, end)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, Tq, H * D)


def flash_decode_quant_reference(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, mask: torch.Tensor,
                                 positions: torch.Tensor | None,
                                 scale: float, chunk: int = KERNEL_CHUNK,
                                 split: int | None = None,
                                 bits: torch.Tensor | None = None,
                                 state: bool = False, t0: int = 0):
    """Plain PyTorch twin of the kernel: mask [S, T] bool, positions
    [S, Tq] (or None; with bits int32 [Tq], the tree mode, key positions
    [S, J]); split None: the kernel's walk (kernel_walk), else all of T
    in states of `split` tokens. Returns f32 [S, Tq, H * D]; with
    state=True the unnormalized partition (o [S, R, D], m [S, R],
    l [S, R]), R = (h, g, tq), positions global and the cache's first
    position t0."""
    Hkv = kq.shape[1]
    if positions is not None and t0:
        positions = positions.long() - t0
    vis = decode_visibility(mask, positions, q.shape[1], bits)
    end = None
    if split is None:
        end, split = kernel_walk(vis, Hkv, q.shape[2] // Hkv, state)
    if not state:
        return flash_decode_visibility_reference(q, kq, ks, vq, vs, vis,
                                                 scale, chunk, split, end)
    return _state_rows(*_decode_state(q, kq, ks, vq, vs, vis, scale, chunk,
                                      split, end))


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
                                 mask: torch.Tensor,
                                 positions: torch.Tensor | None,
                                 scale: float, chunk: int = KERNEL_CHUNK,
                                 split: int | None = None,
                                 state: bool = False,
                                 bits: torch.Tensor | None = None):
    """Plain PyTorch twin of the paged kernel: the gathered slot views
    through the dense twin. Pools [P, Hkv, page(, D)], page_table int32
    [S, MP], mask bool [S, MP * page], positions [S, Tq] or None (with
    bits, [S, J]); split and bits as flash_decode_quant_reference's.
    state=True: (o [S, R, D], m [S, R], l [S, R]) unnormalized, R = (h, g,
    tq)."""
    views = tuple(gather_pages(t, page_table)
                  for t in (k_pool, ks_pool, v_pool, vs_pool))
    Hkv = views[0].shape[1]
    vis = decode_visibility(mask, positions, q.shape[1], bits)
    end = None
    if split is None:
        end, split = kernel_walk(vis, Hkv, q.shape[2] // Hkv, state)
    if not state:
        return flash_decode_visibility_reference(q, *views, vis, scale,
                                                 chunk, split, end)
    return _state_rows(*_decode_state(q, *views, vis, scale, chunk, split,
                                      end))


def _check_shapes(S: int, H: int, Hkv: int, Tq: int, J: int, D: int,
                  T: int, page: int, dev: torch.device, name: str) -> None:
    if H % Hkv or D % 4 or D > MAX_HEAD or H // Hkv * Tq > MAX_ROWS:
        raise ValueError(f"{name}: H={H}, Hkv={Hkv}, Tq={Tq}, D={D}: the "
                         f"kernel takes H % Hkv == 0, D % 4 == 0, "
                         f"D <= {MAX_HEAD} and G * Tq <= {MAX_ROWS}")
    smem = cuda_lib.lib().ps_flash_decode_smem(S, Hkv, H // Hkv, Tq, J, T,
                                               D, page)
    limit = cuda_lib.max_dynamic_smem(dev)
    if smem > limit:
        raise ValueError(f"{name}: G*Tq={H // Hkv * Tq}, T={T}, D={D} "
                         f"needs {smem} bytes of shared memory, the card "
                         f"has {limit}")


def _mask_positions(mask: torch.Tensor, positions: torch.Tensor | None,
                    bits: torch.Tensor | None, dev: torch.device, S: int,
                    Tq: int, T: int) -> tuple:
    """The kernel's mask (uint8 [S, T]), positions (int32 [S, Tq], with
    bits [S, J], or None) and bits (int32 [Tq] or None), and J: views of
    the caller's tensors where they already are."""
    mask = mask.contiguous().view(torch.uint8)
    cuda_lib.require(mask, "mask", dev, (torch.uint8,), (S, T))
    if positions is None:
        if bits is not None:
            raise ValueError("bits name keys: give their positions")
        return mask, None, None, Tq
    positions = positions.to(torch.int32).contiguous()
    J = positions.shape[1] if bits is not None else Tq
    cuda_lib.require(positions, "positions", dev, (torch.int32,), (S, J))
    if bits is not None:
        if not 0 < J <= MAX_KEYS:
            raise ValueError(f"{J} keys: the tree mode takes 1 to "
                             f"{MAX_KEYS}")
        bits = bits.to(torch.int32).contiguous()
        cuda_lib.require(bits, "bits", dev, (torch.int32,), (Tq,))
    return mask, positions, bits, J


def launch_geometry(S: int, Hkv: int, G: int, Tq: int, T: int, D: int,
                    J: int | None = None, page: int = 0,
                    tree: bool = False, splits: int = 0) -> dict:
    """The kernel's launch at these shapes, for a measurement's record:
    splits (the cluster's size), token groups and warps a block, 16-row
    tiles a warp, shared memory bytes, the clusters of that size and
    shared memory the card holds at once (cudaOccupancyMaxActiveClusters;
    of `splits` blocks each where splits > 0) and the grid's clusters
    (S * Hkv). Needs the card."""
    out = (ctypes.c_int * 7)()
    rc = cuda_lib.lib().ps_flash_decode_geometry(
        S, Hkv, G, Tq, Tq if J is None else J, T, D, page, int(tree),
        splits, ctypes.addressof(out))
    cuda_lib.check(rc, "flash_decode geometry")
    keys = ("splits", "token_groups", "warps", "tiles_per_warp",
            "smem_bytes", "max_active_clusters", "clusters")
    return dict(zip(keys, out))


def flash_decode_cuda(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor, mask: torch.Tensor,
                      positions: torch.Tensor | None, scale: float,
                      bits: torch.Tensor | None = None, state: bool = False,
                      t0: int = 0):
    """Launch csrc/flash_decode.cu (all operands on one CUDA device); its
    tree mode with bits, its state mode with state=True (key offset
    t0)."""
    dev = q.device
    S, Tq, H, D = q.shape
    if kq.dim() != 4:
        raise ValueError(f"kq must be [S, Hkv, T, D], got {tuple(kq.shape)}")
    Hkv, T = kq.shape[1], kq.shape[2]
    q = q.float().contiguous()
    cuda_lib.require(q, "q", dev, (torch.float32,), (S, Tq, H, D))
    for name, t in (("kq", kq), ("vq", vq)):
        cuda_lib.require(t, name, dev, (torch.int8,), (S, Hkv, T, D))
    for name, t in (("ks", ks), ("vs", vs)):
        cuda_lib.require(t, name, dev, (torch.float32,), (S, Hkv, T))
    mask, positions, bits, J = _mask_positions(mask, positions, bits, dev,
                                               S, Tq, T)
    _check_shapes(S, H, Hkv, Tq, J, D, T, 0, dev, "flash_decode")
    if state:
        out = torch.empty(S, H * Tq, D, dtype=torch.float32, device=dev)
        m_out = torch.empty(S, H * Tq, dtype=torch.float32, device=dev)
        l_out = torch.empty_like(m_out)
    else:
        out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
        m_out = l_out = None
    rc = cuda_lib.lib().ps_flash_decode(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), mask.data_ptr(), cuda_lib.ptr(positions),
        cuda_lib.ptr(bits), out.data_ptr(), cuda_lib.ptr(m_out),
        cuda_lib.ptr(l_out), S, Tq, J, H, Hkv, T, D, int(t0), float(scale),
        cuda_lib.stream(dev))
    name = (("flash_decode_state" if state else "flash_decode")
            + ("" if bits is None else "_tree"))
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.check(rc, name)
    return (out, m_out, l_out) if state else out


def flash_decode_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor, mask: torch.Tensor,
                       positions: torch.Tensor | None, scale: float,
                       chunk: int = KERNEL_CHUNK,
                       split: int | None = None,
                       bits: torch.Tensor | None = None,
                       state: bool = False, t0: int = 0):
    """q: [S, Tq, H, D]; kq/vq: [S, Hkv, T, D] int8; ks/vs: [S, Hkv, T];
    mask: [S, T] bool; positions: [S, Tq] int (or None: the mask alone);
    bits: int32 [Tq] (pack_intra), the tree mode over key positions
    [S, J]. Returns [S, Tq, H*D] f32; with state=True the unnormalized
    partition (o [S, R, D], m [S, R], l [S, R]), R = (h, g, tq) with tq
    minor, over a cache whose position t is global position t0 + t
    (positions global)."""
    if q.device.type == "cpu":
        return flash_decode_quant_reference(q, kq, ks, vq, vs, mask,
                                            positions, scale, chunk, split,
                                            bits, state, t0)
    if chunk != KERNEL_CHUNK or split is not None:
        raise ValueError(f"the kernel walks {KERNEL_CHUNK}-token steps in "
                         f"its own splits, got {chunk}, {split}")
    return flash_decode_cuda(q, kq, ks, vq, vs, mask, positions, scale, bits,
                             state, t0)


def flash_decode_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            ks_pool: torch.Tensor, v_pool: torch.Tensor,
                            vs_pool: torch.Tensor, page_table: torch.Tensor,
                            mask: torch.Tensor,
                            positions: torch.Tensor | None, scale: float,
                            state: bool = False,
                            bits: torch.Tensor | None = None):
    """Launch csrc/flash_decode.cu in paged mode (one CUDA device); its
    state mode with state=True, its tree mode with bits."""
    dev = q.device
    S, Tq, H, D = q.shape
    if k_pool.dim() != 4:
        raise ValueError(f"k_pool must be [P, Hkv, page, D], got "
                         f"{tuple(k_pool.shape)}")
    P, Hkv, page = k_pool.shape[:3]
    MP = page_table.shape[1]
    T = MP * page
    q = q.float().contiguous()
    pt = page_table.to(torch.int32).contiguous()
    cuda_lib.require(q, "q", dev, (torch.float32,), (S, Tq, H, D))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        cuda_lib.require(t, name, dev, (torch.int8,), (P, Hkv, page, D))
    for name, t in (("ks_pool", ks_pool), ("vs_pool", vs_pool)):
        cuda_lib.require(t, name, dev, (torch.float32,), (P, Hkv, page))
    cuda_lib.require(pt, "page_table", dev, (torch.int32,), (S, MP))
    mask, positions, bits, J = _mask_positions(mask, positions, bits, dev,
                                               S, Tq, T)
    _check_shapes(S, H, Hkv, Tq, J, D, T, page, dev, "flash_decode_paged")
    if state:
        out = torch.empty(S, H * Tq, D, dtype=torch.float32, device=dev)
        m_out = torch.empty(S, H * Tq, dtype=torch.float32, device=dev)
        l_out = torch.empty_like(m_out)
    else:
        out = torch.empty(S, Tq, H * D, dtype=torch.float32, device=dev)
        m_out = l_out = None
    rc = cuda_lib.lib().ps_flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), ks_pool.data_ptr(),
        v_pool.data_ptr(), vs_pool.data_ptr(), pt.data_ptr(),
        mask.data_ptr(), cuda_lib.ptr(positions), cuda_lib.ptr(bits),
        out.data_ptr(), cuda_lib.ptr(m_out), cuda_lib.ptr(l_out), S, Tq, J,
        H, Hkv, MP, page, P, D, float(scale), cuda_lib.stream(dev))
    name = ("flash_decode_paged_state" if state else "flash_decode_paged"
            if bits is None else "flash_decode_paged_tree")
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.check(rc, name)
    return (out, m_out, l_out) if state else out


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       ks_pool: torch.Tensor, v_pool: torch.Tensor,
                       vs_pool: torch.Tensor, page_table: torch.Tensor,
                       mask: torch.Tensor, positions: torch.Tensor | None,
                       scale: float, state: bool = False,
                       bits: torch.Tensor | None = None):
    """q: [S, Tq, H, D]; k_pool/v_pool: [P, Hkv, page, D] int8;
    ks_pool/vs_pool: [P, Hkv, page]; page_table: [S, MP] int32 (P =
    unallocated); mask: [S, MP * page] bool; positions: [S, Tq] int or
    None (the mask alone); bits as flash_decode_quant's.
    Returns [S, Tq, H*D] f32; with state=True the unnormalized partition
    (o [S, R, D], m [S, R], l [S, R]), R = (h, g, tq) with tq minor."""
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k_pool, ks_pool, v_pool,
                                            vs_pool, page_table, mask,
                                            positions, scale, state=state,
                                            bits=bits)
    return flash_decode_paged_cuda(q, k_pool, ks_pool, v_pool, vs_pool,
                                   page_table, mask, positions, scale, state,
                                   bits)


def flash_decode_paged_deferred(q: torch.Tensor, k_pool: torch.Tensor,
                                ks_pool: torch.Tensor, v_pool: torch.Tensor,
                                vs_pool: torch.Tensor,
                                page_table: torch.Tensor,
                                mask: torch.Tensor,
                                knew_q: torch.Tensor, knew_s: torch.Tensor,
                                vnew_q: torch.Tensor, vnew_s: torch.Tensor,
                                intra_vis: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Paged flash-decode with an in-flight block of new K/V that is not
    in the pool yet: the committed pages (mask [S, MP * page]) through the
    state mode, the new
    block (knew_q/vnew_q int8 [S, Hkv, Tq, D], scales [S, Hkv, Tq],
    intra_vis bool [S, Tq, Tq]) as a second softmax partition, merged as
    the JAX package merges them. A partition that a row does not see at
    all (m <= -1e30 / 2) weighs 0. Returns f32 [S, Tq, H * D]."""
    S, Tq, H, D = q.shape
    Hkv = k_pool.shape[1]
    G = H // Hkv
    o1, m1, l1 = flash_decode_paged(q, k_pool, ks_pool, v_pool, vs_pool,
                                    page_table, mask, None, scale,
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
