"""Quantized matmul: GGUF-family weights stay quantized in device memory
and are dequantized inside the matmul kernel.

Weight layout (core/quant.py): contraction dim K on rows, output dim N
contiguous along each row.

  y[m, n] = sum_k x[m, k] * (q[k, n] * scales[k//32, n] - bias[k//32, n])

Storage forms, the same as the JAX package's so the tests compare like
with like:
  - unpacked: q int8 [K, N] (Q8_0, and 4-bit values when K % 128 != 0)
  - packed:   q uint8 [K//2, N], nibbles in pack groups of `pack_group`
              rows (core/quant.py:pack_nib4); Q4_0 nibbles are stored
              +8, Q4_K nibbles are unsigned with the per-block minimum
              in `bias`.
Scales (and minimums) are f32 from the loader or bf16 from
tools/bench_params.py; the kernel reads both.

Two more forms, the JAX package's too:
  - W8 (scale_group 128): symmetric int8 q [K, N] with f32 scales
    [K//128, N] and no minimum (core/quant.py:requantize_w8). `qmatmul`
    runs csrc/qmatmul_w8.cu: a pass quantizes the activations per row to
    int8 (bit-equal to quantize_activations, its twin), then exact int32
    dots over each 128-deep block, each scaled by its block's scale,
    summed in f32, times the row scale.
  - expert stacks (MoE): q [E, K//2, N] or [E, K, N], scales and bias
    [E, K//32, N]; in W8 q int8 [E, K, N] and scales [E, K//128, N].
    `qmatmul_grouped` multiplies rows [i*block_m, (i+1)*block_m) of x by
    slab tile_ids[i] (the grouped mode of csrc/qmatmul.cu, or of
    csrc/qmatmul_w8.cu for W8 slabs); `QLinear.slab(e)` is slab e as a
    2-D view.

Numerics of the kernel and its plain twin: x rounded to bf16, weights
dequantized in f32, f32 accumulation, f32 out. Above GEMV_MAX_M rows
(prefill) the dequantized weights are rounded to bf16 for the tensor
cores — the JAX kernel's split too (f32 dots at decode-sized M, bf16
MXU dots above).

`qmatmul` and `qmatmul_grouped` launch the CUDA kernels for CUDA tensors
and run their plain twins for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.gguf import GGMLType
from ..core.quant import (MXU_GROUP, QK, QuantizedTensor, choose_pack_group,
                          pack_nib4, requantize_w8)
from . import cuda_lib

# decode-sized rows take the GEMV; larger M the tiled kernel
GEMV_MAX_M = 16
# the grouped kernel's tensor-core M tile (block_m above GEMV_MAX_M)
GROUPED_MMA_M = 128


class QLinear(nn.Module):
    """Quantized linear layer: buffers q, scales and bias (the per-block
    minimum, or None) plus the format metadata of the JAX QLinear. The
    buffers carry a leading expert axis for an MoE expert stack; the
    metadata describes one slab."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 bias: torch.Tensor | None, *, packed: bool, unsigned: bool,
                 in_features: int, out_features: int, pack_group: int = 0,
                 scale_group: int = QK):
        super().__init__()
        if scale_group not in (QK, MXU_GROUP):
            raise ValueError(f"scale_group {scale_group}: the GGUF per-{QK} "
                             f"blocks or the W8 per-{MXU_GROUP} format")
        if scale_group == MXU_GROUP and (packed or bias is not None):
            raise ValueError("W8 weights are unpacked int8 with no minimum")
        self.register_buffer("q", q)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)
        self.packed = bool(packed)
        self.unsigned = bool(unsigned)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.pack_group = int(pack_group)
        self.scale_group = int(scale_group)

    @property
    def w8(self) -> bool:
        return self.scale_group == MXU_GROUP

    @property
    def n_slabs(self) -> int:
        """Experts in a stack; 0 for a plain [K, N] weight."""
        return self.q.shape[0] if self.q.dim() == 3 else 0

    def slab(self, e: int) -> "QLinear":
        """Slab e of an expert stack as a 2-D QLinear (views, no copy)."""
        return QLinear(self.q[e], self.scales[e],
                       None if self.bias is None else self.bias[e],
                       packed=self.packed, unsigned=self.unsigned,
                       in_features=self.in_features,
                       out_features=self.out_features,
                       pack_group=self.pack_group,
                       scale_group=self.scale_group)

    @classmethod
    def stack(cls, parts: list["QLinear"]) -> "QLinear":
        """Same-format QLinears stacked on a leading expert axis."""
        head = parts[0]
        return cls(torch.stack([p.q for p in parts]),
                   torch.stack([p.scales for p in parts]),
                   None if head.bias is None
                   else torch.stack([p.bias for p in parts]),
                   packed=head.packed, unsigned=head.unsigned,
                   in_features=head.in_features,
                   out_features=head.out_features,
                   pack_group=head.pack_group, scale_group=head.scale_group)

    @classmethod
    def from_quantized(cls, qt: QuantizedTensor, pack: bool = True,
                       device: str | torch.device | None = None,
                       mxu: bool = False) -> "QLinear":
        """Device tensors from a repacked numpy QuantizedTensor (the
        JAX QLinear.from_quantized layout, f32 scales). mxu=True
        requantizes to the W8 format where K % 128 == 0."""
        dev = resolve_device(device)
        if mxu and qt.k % MXU_GROUP == 0:
            q8, scales = requantize_w8(qt)
            return cls(torch.from_numpy(q8).to(dev),
                       torch.from_numpy(scales).to(dev), None, packed=False,
                       unsigned=False, in_features=qt.k, out_features=qt.n,
                       scale_group=MXU_GROUP)
        is4bit = qt.ggml_type in (GGMLType.Q4_0, GGMLType.Q4_K)
        packed = bool(pack and is4bit and qt.k % 128 == 0)
        unsigned = qt.ggml_type == GGMLType.Q4_K
        group = 0
        if packed:
            group = choose_pack_group(qt.k)
            q = torch.from_numpy(pack_nib4(qt.q, group,
                                           signed_bias=not unsigned))
        else:
            q = torch.from_numpy(qt.q)
        scales = torch.from_numpy(qt.scales.astype("float32"))
        bias = (None if qt.bias is None
                else torch.from_numpy(qt.bias.astype("float32")).to(dev))
        return cls(q.to(dev), scales.to(dev), bias, packed=packed,
                   unsigned=unsigned, in_features=qt.k, out_features=qt.n,
                   pack_group=group)

    @classmethod
    def from_float(cls, w, ggml_type: int | None = None, pack: bool = True,
                   device: str | torch.device | None = None) -> "QLinear":
        """Quantize a float [K, N] numpy weight (tests)."""
        import numpy as np

        from ..core.quant import quantize, repack_gguf_tensor

        ggml_type = GGMLType.Q8_0 if ggml_type is None else ggml_type
        payload = quantize(np.ascontiguousarray(w.T), ggml_type)
        qt = repack_gguf_tensor(payload, ggml_type, (w.shape[1], w.shape[0]))
        return cls.from_quantized(qt, pack=pack, device=device)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.q, self.scales, self.bias) if t is not None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qmatmul(x, self)


def dequant(lin: QLinear) -> torch.Tensor:
    """f32 [K, N] weight, or [E, K, N] for a stack (the plain version's
    dequant)."""
    if lin.packed:
        *lead, kh, n = lin.q.shape
        half = lin.pack_group // 2
        pg = lin.q.reshape(*lead, kh // half, half, n)
        vals = torch.cat([pg & 15, pg >> 4], dim=-2).reshape(*lead, kh * 2, n)
        vals = vals.to(torch.int16)
        if not lin.unsigned:
            vals = vals - 8  # nibbles stored biased (+8)
    else:
        vals = lin.q
    w = vals.float() * lin.scales.float().repeat_interleave(lin.scale_group,
                                                            dim=-2)
    if lin.bias is not None:
        w = w - lin.bias.float().repeat_interleave(QK, dim=-2)
    return w


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-row symmetric int8: x [M, K] -> (x8 int8 [M, K], f32 scale
    [M, 1]); the JAX package's _quantize_activations."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, which is not JAX's division
    sx = amax / torch.full_like(amax, 127.0)
    inv = torch.where(sx > 0, 1.0 / torch.where(sx == 0, 1.0, sx), 0.0)
    x8 = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return x8, sx


def qmatmul_w8_reference(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """Plain twin of csrc/qmatmul_w8.cu: x [M, K] rounded to bf16, then
    int8 per row -> f32 [M, N]. Each 128-deep dot of integers below 2^24
    is exact in f32, so only the sum over blocks is rounded."""
    m, k = x.shape
    kb = k // MXU_GROUP
    x8, sx = quantize_activations(x.to(torch.bfloat16))
    xb = x8.float().reshape(m, kb, MXU_GROUP).transpose(0, 1)
    qb = lin.q.float().reshape(kb, MXU_GROUP, lin.out_features)
    part = torch.bmm(xb, qb)  # [KB, M, N], exact
    return (part * lin.scales.float()[:, None, :]).sum(dim=0) * sx


def qmatmul_reference(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """Plain PyTorch twin of the kernels: x [M, K] -> f32 [M, N]."""
    if lin.w8:
        return qmatmul_w8_reference(x, lin)
    w = dequant(lin)
    if x.shape[0] > GEMV_MAX_M:
        w = w.to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def qmatmul_grouped_reference(x: torch.Tensor, lin: QLinear,
                              tile_ids: torch.Tensor,
                              block_m: int) -> torch.Tensor:
    """Plain twin of the grouped kernels: x [P, K] -> f32 [P, N], rows of
    tile i times slab tile_ids[i] (clipped into the stack). The weights
    round to bf16 when block_m > GEMV_MAX_M, the kernel's tile split; W8
    slabs take qmatmul_w8_reference per tile (its rows quantize one by
    one, so a tile's product is the dense one's)."""
    p, k = x.shape
    ids = tile_ids.long().clamp(0, lin.n_slabs - 1)
    if lin.w8:
        xt = x.reshape(p // block_m, block_m, k)
        out = [qmatmul_w8_reference(xt[i], lin.slab(e))
               for i, e in enumerate(ids.tolist())]
        return (torch.cat(out) if out else
                torch.zeros(0, lin.out_features, device=x.device))
    w = dequant(lin)
    if block_m > GEMV_MAX_M:
        w = w.to(torch.bfloat16).float()
    xt = x.to(torch.bfloat16).float().reshape(p // block_m, block_m, k)
    return torch.bmm(xt, w[ids]).reshape(p, lin.out_features)


def weight_args(lin: QLinear, device: torch.device,
                stacked: bool = False) -> tuple:
    """Check a GGUF-format QLinear (an expert stack if `stacked`) against
    what the kernels take and return
    (q, scales, bias, packed, group, offset, scale_bf16)."""
    k, n = lin.in_features, lin.out_features
    if lin.w8:
        raise ValueError("a W8 weight goes to the W8 kernel")
    if k % QK:
        raise ValueError(f"K={k} is not a multiple of {QK}")
    lead = (None,) if stacked else ()
    rows = k // 2 if lin.packed else k
    qdt = (torch.uint8,) if lin.packed else (torch.int8,)
    cuda_lib.require(lin.q, "q", device, qdt, (*lead, rows, n))
    sdt = (torch.float32, torch.bfloat16)
    cuda_lib.require(lin.scales, "scales", device, sdt, (*lead, k // QK, n))
    if lin.bias is not None:
        cuda_lib.require(lin.bias, "bias", device, (lin.scales.dtype,),
                         (*lead, k // QK, n))
    if lin.q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned")
    if lin.packed and (lin.pack_group % 64 or k % lin.pack_group):
        raise ValueError(f"pack group {lin.pack_group} does not tile K={k}")
    offset = 8 if lin.packed and not lin.unsigned else 0
    return (lin.q, lin.scales, lin.bias, int(lin.packed), lin.pack_group,
            offset, int(lin.scales.dtype == torch.bfloat16))


def qmatmul_cuda(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """Launch csrc/qmatmul.cu: x [M, K] on a CUDA device -> f32 [M, N]."""
    dev = x.device
    q, s, b, packed, group, offset, sbf16 = weight_args(lin, dev)
    m, k = x.shape
    if k != lin.in_features:
        raise ValueError(f"x has K={k}, weight K={lin.in_features}")
    n = lin.out_features
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the tensor-core path loads 16-byte vectors
        xb = xb.clone()
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    rc = cuda_lib.lib().ps_qmatmul(
        xb.data_ptr(), q.data_ptr(), s.data_ptr(), cuda_lib.ptr(b),
        out.data_ptr(), m, k, n, packed, group, offset, sbf16,
        cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["qmatmul"] += 1
    cuda_lib.check(rc, "qmatmul")
    return out


def _w8_rows(x: torch.Tensor, lin: QLinear | None,
             stacked: bool = False) -> torch.Tensor:
    """Check x [M, K] on a CUDA device against the W8 weight `lin` (None:
    K alone; an expert stack if `stacked`) and return it as the kernel's
    contiguous, 16-byte aligned bf16 rows (the model's rows already are:
    no copy)."""
    dev = x.device
    m, k = x.shape
    if k % MXU_GROUP:
        raise ValueError(f"W8 kernel: x {tuple(x.shape)}, K not a multiple "
                         f"of {MXU_GROUP}")
    if lin is not None:
        if not lin.w8 or k != lin.in_features:
            raise ValueError(f"W8 kernel: x {tuple(x.shape)} against a "
                             f"scale_group {lin.scale_group} weight of K="
                             f"{lin.in_features}")
        n = lin.out_features
        lead = (None,) if stacked else ()
        cuda_lib.require(lin.q, "q", dev, (torch.int8,), (*lead, k, n))
        cuda_lib.require(lin.scales, "scales", dev, (torch.float32,),
                         (*lead, k // MXU_GROUP, n))
        if lin.q.data_ptr() % 4:
            raise ValueError("q must be 4-byte aligned")
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def quantize_activations_cuda(x: torch.Tensor) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The W8 kernel's quantize pass alone (checks and timing; the
    product runs it itself): x [M, K] on a CUDA device -> (x8 int8 [M, K],
    f32 scale [M, 1]), bit-equal to quantize_activations(x.to(bfloat16))."""
    x = _w8_rows(x, None)
    m, k = x.shape
    x8 = torch.empty(m, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m:
        cuda_lib.check(cuda_lib.lib().ps_w8_quantize(
            x.data_ptr(), x8.data_ptr(), sx.data_ptr(), m, k,
            cuda_lib.stream(x.device)), "w8 quantize pass")
    return x8, sx


def qmatmul_w8_cuda(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """Launch csrc/qmatmul_w8.cu: x [M, K] on a CUDA device -> f32 [M, N].
    One C call: the quantize pass into scratch, then the product."""
    x = _w8_rows(x, lin)
    dev = x.device
    m, k = x.shape
    n = lin.out_features
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    # int8 codes [M, K], then the f32 row scales (M * K % 128 == 0)
    scratch = torch.empty(m * k + 4 * m, dtype=torch.uint8, device=dev)
    rc = cuda_lib.lib().ps_qmatmul_w8(
        x.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + m * k,
        lin.q.data_ptr(), lin.scales.data_ptr(), out.data_ptr(), m, k, n,
        cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["qmatmul_w8"] += 1
    cuda_lib.check(rc, "qmatmul_w8")
    return out


def _tile_ids(tile_ids: torch.Tensor, p: int, block_m: int,
              device: torch.device) -> torch.Tensor:
    """Check block_m against what the grouped kernels take and return
    tile_ids as the kernels' contiguous int32 [P // block_m]."""
    if not (1 <= block_m <= GEMV_MAX_M or block_m == GROUPED_MMA_M) \
            or p % block_m:
        raise ValueError(f"grouped qmatmul: block_m {block_m} (1..."
                         f"{GEMV_MAX_M} or {GROUPED_MMA_M}) must tile "
                         f"P={p}")
    ids = tile_ids.to(torch.int32).contiguous()
    cuda_lib.require(ids, "tile_ids", device, (torch.int32,),
                     (p // block_m,))
    return ids


def qmatmul_w8_grouped_cuda(x: torch.Tensor, lin: QLinear,
                            tile_ids: torch.Tensor,
                            block_m: int) -> torch.Tensor:
    """Launch the grouped mode of csrc/qmatmul_w8.cu: x [P, K] on a CUDA
    device, a W8 expert stack, tile_ids [P // block_m] -> f32 [P, N]. One
    C call: the quantize pass over all P rows, then the product."""
    x = _w8_rows(x, lin, stacked=True)
    dev = x.device
    p, k = x.shape
    n = lin.out_features
    ids = _tile_ids(tile_ids, p, block_m, dev)
    out = torch.empty(p, n, dtype=torch.float32, device=dev)
    if p == 0:
        return out
    scratch = torch.empty(p * k + 4 * p, dtype=torch.uint8, device=dev)
    rc = cuda_lib.lib().ps_qmatmul_w8_grouped(
        x.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + p * k,
        lin.q.data_ptr(), lin.scales.data_ptr(), ids.data_ptr(),
        out.data_ptr(), p, k, n, lin.n_slabs, block_m, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["qmatmul_w8_grouped"] += 1
    cuda_lib.check(rc, "qmatmul_w8_grouped")
    return out


def qmatmul_grouped_cuda(x: torch.Tensor, lin: QLinear,
                         tile_ids: torch.Tensor,
                         block_m: int) -> torch.Tensor:
    """Launch the grouped mode of csrc/qmatmul.cu: x [P, K] on a CUDA
    device, tile_ids [P // block_m] -> f32 [P, N]."""
    dev = x.device
    q, s, b, packed, group, offset, sbf16 = weight_args(lin, dev,
                                                        stacked=True)
    p, k = x.shape
    n = lin.out_features
    if k != lin.in_features:
        raise ValueError(f"x has K={k}, weight K={lin.in_features}")
    ids = _tile_ids(tile_ids, p, block_m, dev)
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    out = torch.empty(p, n, dtype=torch.float32, device=dev)
    if p == 0:
        return out
    rc = cuda_lib.lib().ps_qmatmul_grouped(
        xb.data_ptr(), q.data_ptr(), s.data_ptr(), cuda_lib.ptr(b),
        ids.data_ptr(), out.data_ptr(), p, k, n, packed, group, offset,
        sbf16, lin.n_slabs, block_m, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["qmatmul_grouped"] += 1
    cuda_lib.check(rc, "qmatmul_grouped")
    return out


def qmatmul(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """y = x @ dequant(lin): x [..., K] -> f32 [..., N]. CUDA tensors run
    the kernel (the W8 kernel for a W8 weight); CPU tensors the plain
    twin."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = qmatmul_reference(x2, lin)
    elif lin.w8:
        y = qmatmul_w8_cuda(x2, lin)
    else:
        y = qmatmul_cuda(x2, lin)
    return y.reshape(*lead, lin.out_features)


def qmatmul_grouped(x: torch.Tensor, lin: QLinear, tile_ids: torch.Tensor,
                    block_m: int) -> torch.Tensor:
    """Rows [i*block_m, (i+1)*block_m) of x [P, K] times slab tile_ids[i]
    of the expert stack `lin` -> f32 [P, N] (the MoE dispatch,
    ops/moe.py). CUDA tensors run the kernel (the W8 kernel's grouped
    mode for W8 slabs); CPU tensors the plain twin."""
    if x.shape[0] % block_m:
        raise ValueError(f"P={x.shape[0]} is not a multiple of {block_m}")
    if x.device.type == "cpu":
        return qmatmul_grouped_reference(x, lin, tile_ids, block_m)
    if lin.w8:
        return qmatmul_w8_grouped_cuda(x, lin, tile_ids, block_m)
    return qmatmul_grouped_cuda(x, lin, tile_ids, block_m)
