"""Fused linear: prologue + quantized matmul + epilogue (csrc/
fused_linear.cu: a prologue pass, then the decode GEMV of csrc/gemv.cuh
with the epilogue in its merge), the JAX package's fused_linear.

Exactly one prologue forms the bf16 matmul input x [M, K]:
  x:       an activation [M, K], rounded to bf16
  parts:   two activations [M, K1], [M, K - K1] concatenated (concat2,
           the EAGLE fc input)
  norm:    (a0[, a1[, a2]], w): the operands summed in f32 in the order
           given, f32 rms-norm times w, rounded to bf16 (the final norm
           of the head; norm(x + attn_out) of a fused decode layer)
  glu:     a gate|up block [M, 2K]: silu(g) * u in f32, rounded to bf16
Epilogue on the f32 product: + bias [N], then (r0 + r1) + y for the
residuals given (the residual stream), then optionally the greedy argmax
(first occurrence on ties, as jnp.argmax). Numerics follow the TPU
kernel: f32 dequant, f32 sums, f32 out.

fused_linear launches the kernel for up to 16 rows of CUDA tensors (the
decode-sized batches it is for); CPU tensors run the plain twin
`fused_linear_reference`. More than 16 rows (the prefill "all" logits, a
batched verify) compose the same prologue with the qmatmul kernel and
the epilogue in PyTorch, as the JAX package does past its fused kernel's
M <= 16. A W8 weight is not the fused kernel's format: on every device
it takes the same composition with the W8 qmatmul (the JAX package's
`fusable` refuses it too).

Each launch counts under the name of its mode: "fused_head" (norm over
one operand, no epilogue but the argmax: the lm_head, the QKV of a fused
layer, a factored head's U), "fused_norm" (norm over a sum, or with bias
or residuals), "fused_x", "fused_x_argmax", "fused_glu",
"fused_concat2".
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .qmatmul import (QLinear, dequant, qmatmul, qmatmul_reference,
                      weight_args)

FUSED_MAX_M = 16
_HEAD_COLS = 128
_PROLOGUES = {"x": 0, "norm": 1, "glu": 2, "concat2": 3}


def _select(x, parts, norm, glu) -> tuple[str, list, torch.Tensor | None]:
    """(prologue, operands as [M, *] rows, norm weight or None)."""
    if sum(v is not None for v in (x, parts, norm, glu)) != 1:
        raise ValueError("give exactly one of x, parts, norm, glu")
    nw = None
    if norm is not None:
        *ops, nw = norm
        pro = "norm"
        if not 1 <= len(ops) <= 3:
            raise ValueError(f"norm sums 1-3 operands, got {len(ops)}")
    elif glu is not None:
        pro, ops = "glu", [glu]
    elif parts is not None:
        pro, ops = "concat2", list(parts)
        if len(ops) != 2:
            raise ValueError(f"parts takes two operands, got {len(ops)}")
    else:
        pro, ops = "x", [x]
    return pro, [o.reshape(-1, o.shape[-1]) for o in ops], nw


def _norm_pre(ops: list, nw: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm prologue before its bf16 rounding, f32 [M, K]."""
    a = ops[0].float()
    for o in ops[1:]:
        a = a + o.float()
    var = (a * a).mean(dim=-1, keepdim=True)
    return (a * torch.rsqrt(var + eps)) * nw.float()


def _glu_pre(gu: torch.Tensor) -> torch.Tensor:
    """silu(g) * u of a gate|up block [M, 2K], f32, before rounding."""
    gu = gu.float()
    f = gu.shape[-1] // 2
    g, u = gu[:, :f], gu[:, f:]
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def prologue_reference(pro: str, ops: list, nw: torch.Tensor | None,
                       eps: float = 1e-5) -> torch.Tensor:
    """The kernel's bf16 matmul input x [M, K]."""
    if pro == "norm":
        return _norm_pre(ops, nw, eps).to(torch.bfloat16)
    if pro == "glu":
        return _glu_pre(ops[0]).to(torch.bfloat16)
    if pro == "concat2":
        return torch.cat([o.to(torch.bfloat16) for o in ops], dim=1)
    return ops[0].to(torch.bfloat16)


def epilogue_reference(y: torch.Tensor, bias: torch.Tensor | None,
                       resids: list, argmax: bool) -> torch.Tensor:
    """bias, then (r0 + r1) + y, then the optional argmax."""
    if bias is not None:
        y = y + bias.float().reshape(-1)
    if resids:
        rs = resids[0].float()
        for r in resids[1:]:
            rs = rs + r.float()
        y = rs + y
    return y.argmax(dim=-1).to(torch.int32) if argmax else y


def fused_linear_reference(lin: QLinear, *, x=None, parts=None, norm=None,
                           glu=None, bias=None, resids=(),
                           argmax: bool = False,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (of the composition with the W8
    product for a W8 weight): f32 [M, N], or int32 [M] with argmax=True."""
    pro, ops, nw = _select(x, parts, norm, glu)
    resids = [r.reshape(-1, r.shape[-1]) for r in resids]
    return _plain(lin, pro, ops, nw, bias, resids, argmax, eps)


def _plain(lin, pro, ops, nw, bias, resids, argmax, eps) -> torch.Tensor:
    x = prologue_reference(pro, ops, nw, eps)
    # a W8 weight composes with the W8 product, whose twin this is
    y = qmatmul_reference(x, lin) if lin.w8 else x.float() @ dequant(lin)
    return epilogue_reference(y, bias, resids, argmax)


def _midpoint_slack(pre: torch.Tensor, lin: QLinear) -> torch.Tensor:
    """How far each output may move when the f32 prologue values `pre`
    [M, K] change in their last bits before their bf16 rounding: an
    element within 64 f32 ulps of a bf16 rounding midpoint may round
    either way, moving output n by one bf16 ulp times |w[k, n]|. Returns
    f32 [M, N]: zero where no element lies near a midpoint."""
    pre = pre.contiguous()
    low = pre.view(torch.int32) & 0xFFFF  # the bits bf16 rounds away
    near = (low - 0x8000).abs() <= 64
    _, e = torch.frexp(pre)
    ulp = torch.ldexp(torch.ones_like(pre), e - 8)  # bf16 spacing
    return (near * ulp) @ dequant(lin).abs()


def norm_rounding_slack(lin: QLinear, *norm, eps: float = 1e-5
                        ) -> torch.Tensor:
    """The slack of the norm prologue over norm = (a0[, a1, a2], w): two
    computations that differ only in the last bits of the f32 norm
    (another summation order of the mean square)."""
    *ops, nw = norm
    ops = [o.reshape(-1, o.shape[-1]) for o in ops]
    return _midpoint_slack(_norm_pre(ops, nw, eps), lin)


def glu_rounding_slack(lin: QLinear, gu: torch.Tensor) -> torch.Tensor:
    """The slack of the glu prologue: exp on the card and on the host may
    differ in the last bit of silu(g) * u."""
    return _midpoint_slack(_glu_pre(gu.reshape(-1, gu.shape[-1])), lin)


def launch_name(pro: str, n_ops: int, bias, resids, argmax: bool) -> str:
    """The LAUNCHES entry a call of this mode counts under."""
    if pro == "norm":
        plain = n_ops == 1 and bias is None and not resids
        return "fused_head" if plain else "fused_norm"
    if pro == "x":
        return "fused_x_argmax" if argmax else "fused_x"
    return f"fused_{pro}"


def _f32_or_bf16(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads an operand: f32 or bf16, contiguous."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.contiguous()


def fused_linear_cuda(lin: QLinear, pro: str, ops: list,
                      nw: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None, resids=(),
                      argmax: bool = False, eps: float = 1e-5
                      ) -> torch.Tensor:
    """Launch csrc/fused_linear.cu for the operands `ops` ([M, *] rows,
    M <= 16) of prologue `pro` on a CUDA device."""
    dev = ops[0].device
    q, s, b, packed, group, offset, sbf16 = weight_args(lin, dev)
    m = ops[0].shape[0]
    k, n = lin.in_features, lin.out_features
    if m > FUSED_MAX_M:
        raise ValueError(f"fused linear takes M <= {FUSED_MAX_M} rows, "
                         f"got {m}")
    ops = [_f32_or_bf16(o) for o in ops]
    k1 = ops[0].shape[1] if pro == "concat2" else 0
    widths = {"glu": [2 * k], "concat2": [k1, k - k1]}.get(pro, [k] * len(ops))
    for i, (o, w) in enumerate(zip(ops, widths)):
        cuda_lib.require(o, f"operand {i}", dev, (o.dtype,), (m, w))
    if pro == "concat2" and not 0 < k1 < k:
        raise ValueError(f"concat2 parts of {k1} and {k - k1} columns")
    if pro == "norm":
        nw = nw.float().contiguous()
        cuda_lib.require(nw, "norm weight", dev, (torch.float32,), (k,))
    if bias is not None:
        bias = bias.float().reshape(-1).contiguous()
        cuda_lib.require(bias, "bias", dev, (torch.float32,), (n,))
    resids = [_f32_or_bf16(r.reshape(-1, r.shape[-1])) for r in resids]
    if len(resids) > 2:
        raise ValueError(f"at most two residuals, got {len(resids)}")
    for i, r in enumerate(resids):
        cuda_lib.require(r, f"residual {i}", dev, (r.dtype,), (m, n))
    if argmax:
        logits = None
        nblk = -(-n // _HEAD_COLS)
        best_val = torch.empty(nblk, m, dtype=torch.float32, device=dev)
        best_idx = torch.empty(nblk, m, dtype=torch.int32, device=dev)
        out = torch.empty(m, dtype=torch.int32, device=dev)
    else:
        logits = out = torch.empty(m, n, dtype=torch.float32, device=dev)
        best_val = best_idx = None
    if m == 0:
        return out
    x = torch.empty(m, k, dtype=torch.bfloat16, device=dev)  # the prologue
    p = [cuda_lib.ptr(o) for o in ops] + [None] * (3 - len(ops))
    r = [cuda_lib.ptr(t) for t in resids] + [None] * (2 - len(resids))
    bits = lambda ts: sum(1 << i for i, t in enumerate(ts)  # noqa: E731
                          if t.dtype == torch.bfloat16)
    rc = cuda_lib.lib().ps_fused_linear(
        _PROLOGUES[pro], len(ops), *p, bits(ops), k1, cuda_lib.ptr(nw),
        float(eps), x.data_ptr(), q.data_ptr(), s.data_ptr(),
        cuda_lib.ptr(b), m, k, n,
        packed, group, offset, sbf16, cuda_lib.ptr(bias), len(resids), *r,
        bits(resids), cuda_lib.ptr(logits), cuda_lib.ptr(best_val),
        cuda_lib.ptr(best_idx), out.data_ptr() if argmax else None,
        cuda_lib.stream(dev))
    name = launch_name(pro, len(ops), bias, resids, argmax)
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.check(rc, name)
    return out


def fused_linear(lin: QLinear, *, x=None, parts=None, norm=None, glu=None,
                 bias=None, resids=(), argmax: bool = False,
                 eps: float = 1e-5) -> torch.Tensor:
    """One fused (prologue -> quantized matmul -> epilogue) call: f32
    [M, N], or int32 greedy tokens [M] with argmax=True. Operands may
    carry leading dims; they are flattened to rows."""
    pro, ops, nw = _select(x, parts, norm, glu)
    resids = [r.reshape(-1, r.shape[-1]) for r in resids]
    if ops[0].device.type == "cpu":
        return _plain(lin, pro, ops, nw, bias, resids, argmax, eps)
    if ops[0].shape[0] > FUSED_MAX_M or lin.w8:
        y = qmatmul(prologue_reference(pro, ops, nw, eps), lin)
        return epilogue_reference(y, bias, resids, argmax)
    return fused_linear_cuda(lin, pro, ops, nw, bias, resids, argmax, eps)
