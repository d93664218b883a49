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

Numerics of the kernel and its plain twin: x rounded to bf16, weights
dequantized in f32, f32 accumulation, f32 out. Above GEMV_MAX_M rows
(prefill) the dequantized weights are rounded to bf16 for the tensor
cores — the JAX kernel's split too (f32 dots at decode-sized M, bf16
MXU dots above).

`qmatmul` launches the CUDA kernel (csrc/qmatmul.cu) for CUDA tensors
and runs the plain `qmatmul_reference` for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.gguf import GGMLType
from ..core.quant import QK, QuantizedTensor, choose_pack_group, pack_nib4
from . import cuda_lib

# decode-sized rows take the split-K GEMV; larger M the tiled kernel
GEMV_MAX_M = 16


class QLinear(nn.Module):
    """Quantized linear layer: buffers q, scales and bias (the per-block
    minimum, or None) plus the format metadata of the JAX QLinear."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 bias: torch.Tensor | None, *, packed: bool, unsigned: bool,
                 in_features: int, out_features: int, pack_group: int = 0,
                 scale_group: int = QK):
        super().__init__()
        if scale_group != QK:
            raise ValueError(f"scale_group {scale_group}: only the GGUF "
                             f"per-{QK} block format is ported")
        self.register_buffer("q", q)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)
        self.packed = bool(packed)
        self.unsigned = bool(unsigned)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.pack_group = int(pack_group)
        self.scale_group = QK

    @classmethod
    def from_quantized(cls, qt: QuantizedTensor, pack: bool = True,
                       device: str | torch.device | None = None) -> "QLinear":
        """Device tensors from a repacked numpy QuantizedTensor (the
        JAX QLinear.from_quantized layout, f32 scales)."""
        dev = resolve_device(device)
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
    """f32 [K, N] weight (the plain version's dequant)."""
    if lin.packed:
        kh, n = lin.q.shape
        half = lin.pack_group // 2
        pg = lin.q.reshape(kh // half, half, n)
        vals = torch.cat([pg & 15, pg >> 4], dim=1).reshape(kh * 2, n)
        vals = vals.to(torch.int16)
        if not lin.unsigned:
            vals = vals - 8  # nibbles stored biased (+8)
    else:
        vals = lin.q
    w = vals.float() * lin.scales.float().repeat_interleave(QK, dim=0)
    if lin.bias is not None:
        w = w - lin.bias.float().repeat_interleave(QK, dim=0)
    return w


def qmatmul_reference(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: x [M, K] -> f32 [M, N]."""
    w = dequant(lin)
    if x.shape[0] > GEMV_MAX_M:
        w = w.to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def weight_args(lin: QLinear, device: torch.device) -> tuple:
    """Check a QLinear against what the kernels take and return
    (q, scales, bias, packed, group, offset, scale_bf16)."""
    k, n = lin.in_features, lin.out_features
    if k % QK:
        raise ValueError(f"K={k} is not a multiple of {QK}")
    rows = k // 2 if lin.packed else k
    qdt = (torch.uint8,) if lin.packed else (torch.int8,)
    cuda_lib.require(lin.q, "q", device, qdt, (rows, n))
    sdt = (torch.float32, torch.bfloat16)
    cuda_lib.require(lin.scales, "scales", device, sdt, (k // QK, n))
    if lin.bias is not None:
        cuda_lib.require(lin.bias, "bias", device, (lin.scales.dtype,),
                         (k // QK, n))
    if lin.q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned")
    if lin.packed and (lin.pack_group % 64 or k % lin.pack_group):
        raise ValueError(f"pack group {lin.pack_group} does not tile K={k}")
    offset = 8 if lin.packed and not lin.unsigned else 0
    return (lin.q, lin.scales, lin.bias, int(lin.packed), lin.pack_group,
            offset, int(lin.scales.dtype == torch.bfloat16))


def gemv_splits(m: int, k: int, n: int, device: torch.device) -> int:
    """K splits for the decode GEMV: about four blocks per SM, each split
    at least eight scale blocks (one per warp of a block)."""
    if m > GEMV_MAX_M:
        return 1
    col_tiles = -(-n // 128)
    want = -(-4 * cuda_lib.sm_count(device) // col_tiles)
    return max(1, min(want, (k // QK) // 8))


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
    splits = gemv_splits(m, k, n, dev)
    part = (torch.empty(splits, m, n, dtype=torch.float32, device=dev)
            if splits > 1 else None)
    L = cuda_lib.lib()
    rc = L.ps_qmatmul(xb.data_ptr(), q.data_ptr(), s.data_ptr(),
                      cuda_lib.ptr(b), out.data_ptr(), cuda_lib.ptr(part),
                      m, k, n, packed, group, offset, sbf16, splits,
                      cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["qmatmul"] += 1
    cuda_lib.check(rc, "qmatmul")
    return out


def qmatmul(x: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """y = x @ dequant(lin): x [..., K] -> f32 [..., N]. CUDA tensors run
    the kernel; CPU tensors the plain twin."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = qmatmul_reference(x2, lin)
    else:
        y = qmatmul_cuda(x2, lin)
    return y.reshape(*lead, lin.out_features)
