"""Fused decode head: rms-norm prologue + quantized matmul + optional
greedy argmax in one kernel (csrc/fused_head.cu).

The "head" scope of the JAX package's fused_linear: the final norm and
the lm_head of every decode step, with the greedy argmax epilogue in
decode_scan. The prologue matches the JAX kernel's rounding: f32 rms-norm
of the row, times the norm weight, rounded to bf16 (and back to f32)
before the dot.

fused_linear launches the kernel for up to 16 rows of CUDA tensors (the
decode-sized batches it is for); CPU tensors run the plain twin
`fused_linear_reference`. More than 16 rows (the prefill "all" logits)
compose the same norm with the qmatmul kernel, as the JAX package does
past its fused kernel's M <= 16. A W8 lm_head is not the fused kernel's
format: on every device it takes the same composition with the W8
qmatmul (the JAX package's `fusable` refuses it too).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .elementwise import rms_norm
from .qmatmul import QLinear, dequant, qmatmul, weight_args

FUSED_MAX_M = 16
_HEAD_COLS = 128
_STATIC_SMEM = 8 * _HEAD_COLS * 4 + FUSED_MAX_M * 4


def fused_linear_reference(lin: QLinear, x: torch.Tensor, norm_w: torch.Tensor,
                           argmax: bool = False,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin: x [M, K] -> f32 logits [M, N] or int32 [M]."""
    a = x.float()
    var = (a * a).mean(dim=-1, keepdim=True)
    xn = (a * torch.rsqrt(var + eps)) * norm_w.float()
    y = xn.to(torch.bfloat16).float() @ dequant(lin)
    return y.argmax(dim=-1).to(torch.int32) if argmax else y


def norm_rounding_slack(lin: QLinear, x: torch.Tensor, norm_w: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """How far each head logit may move between two computations of the
    prologue that differ only in the last bits of the f32 norm (another
    summation order of the mean square). An element of the normalized
    rows within 64 f32 ulps of a bf16 rounding midpoint may round
    either way, moving logit n by one bf16 ulp times |w[k, n]|. Returns
    f32 [M, N]: zero where no element lies near a midpoint."""
    a = x.reshape(-1, x.shape[-1]).float()
    var = (a * a).mean(dim=-1, keepdim=True)
    xn = (a * torch.rsqrt(var + eps)) * norm_w.float()
    low = xn.view(torch.int32) & 0xFFFF  # the bits bf16 rounds away
    near = (low - 0x8000).abs() <= 64
    _, e = torch.frexp(xn)
    ulp = torch.ldexp(torch.ones_like(xn), e - 8)  # bf16 spacing at xn
    return (near * ulp) @ dequant(lin).abs()


def fused_head_cuda(lin: QLinear, x: torch.Tensor, norm_w: torch.Tensor,
                    argmax: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Launch csrc/fused_head.cu for x [M, K] (M <= 16) on a CUDA device."""
    dev = x.device
    q, s, b, packed, group, offset, sbf16 = weight_args(lin, dev)
    m, k = x.shape
    n = lin.out_features
    if k != lin.in_features or m > FUSED_MAX_M:
        raise ValueError(f"fused head takes [M <= {FUSED_MAX_M}, "
                         f"{lin.in_features}] rows, got {tuple(x.shape)}")
    if m * k * 2 + _STATIC_SMEM > cuda_lib.max_dynamic_smem(dev):
        raise ValueError(f"fused head: {m} rows of K={k} do not fit in "
                         f"shared memory")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    nw = norm_w.float().contiguous()
    cuda_lib.require(nw, "norm weight", dev, (torch.float32,), (k,))
    nblk = -(-n // _HEAD_COLS)
    if argmax:
        logits = None
        best_val = torch.empty(nblk, m, dtype=torch.float32, device=dev)
        best_idx = torch.empty(nblk, m, dtype=torch.int32, device=dev)
        out = torch.empty(m, dtype=torch.int32, device=dev)
    else:
        logits = out = torch.empty(m, n, dtype=torch.float32, device=dev)
        best_val = best_idx = None
    if m == 0:
        return out
    rc = cuda_lib.lib().ps_fused_head(
        x.data_ptr(), int(x.dtype == torch.bfloat16), nw.data_ptr(),
        float(eps), q.data_ptr(), s.data_ptr(), cuda_lib.ptr(b), m, k, n,
        packed, group, offset, sbf16, cuda_lib.ptr(logits),
        cuda_lib.ptr(best_val), cuda_lib.ptr(best_idx),
        out.data_ptr() if argmax else None, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["fused_head"] += 1
    cuda_lib.check(rc, "fused_head")
    return out


def fused_linear(lin: QLinear, *, norm: tuple, argmax: bool = False,
                 eps: float = 1e-5) -> torch.Tensor:
    """lin(bf16(rms_norm(x, w))) for norm=(x [M, K], w [K]); returns f32
    logits [M, N], or int32 greedy tokens [M] with argmax=True (first
    occurrence on ties, as jnp.argmax)."""
    x, norm_w = norm
    x = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu" and not lin.w8:
        return fused_linear_reference(lin, x, norm_w, argmax, eps)
    if x.shape[0] > FUSED_MAX_M or lin.w8:
        y = qmatmul(rms_norm(x, norm_w, eps).to(torch.bfloat16), lin)
        return y.argmax(dim=-1).to(torch.int32) if argmax else y
    return fused_head_cuda(lin, x, norm_w, argmax, eps)
