"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the kernels and the twins do the same f32 arithmetic on the
same bf16-rounded inputs and sum in another order, so they agree to
f32 rounding (relative to the largest output). The fused head also
rounds its normalized rows to bf16 after an f32 norm summed in another
order: an element next to a bf16 rounding midpoint may round the other
way, which ops.fused.norm_rounding_slack bounds per logit.
"""

import numpy as np
import pytest
import torch

from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.ops import cuda_lib
from powerserve_tpu_torch.ops.flash_decode import (
    flash_decode_cuda, flash_decode_quant_reference)
from powerserve_tpu_torch.ops.fused import (fused_head_cuda,
                                            fused_linear_reference,
                                            norm_rounding_slack)
from powerserve_tpu_torch.ops.qmatmul import (QLinear, qmatmul_cuda,
                                              qmatmul_reference)

pytestmark = pytest.mark.cuda

REL = 2e-5  # f32 sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, ref, rel=REL, slack=0.0):
    got, ref = got.float().cpu(), ref.float().cpu()
    err = (got - ref).abs()
    tol = rel * max(1.0, ref.abs().max().item()) + slack
    assert (err <= tol).all(), (err.max().item(), (err - tol).max().item())


def _lin(fmt, k, n, pack, seed, bf16=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    lin = QLinear.from_float(w, fmt, pack=pack, device="cpu")
    if bf16:
        lin.scales = lin.scales.to(torch.bfloat16)
        if lin.bias is not None:
            lin.bias = lin.bias.to(torch.bfloat16)
    return lin


QMM_CASES = [
    (GGMLType.Q4_0, 512, 384, True), (GGMLType.Q4_K, 512, 384, True),
    (GGMLType.Q8_0, 512, 384, False), (GGMLType.Q4_0, 96, 130, False),
    (GGMLType.Q4_K, 256, 202, False), (GGMLType.Q8_0, 64, 1, False),
    (GGMLType.Q4_K, 1024, 640, True), (GGMLType.Q4_0, 896, 136, True),
]


@pytest.mark.parametrize("fmt,k,n,pack", QMM_CASES)
@pytest.mark.parametrize("m", [1, 3, 16, 17, 70])
@pytest.mark.parametrize("bf16", [False, True])
def test_qmatmul_kernel(dev, fmt, k, n, pack, m, bf16):
    lin = _lin(fmt, k, n, pack, seed=k + n, bf16=bf16).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + m)
    x = torch.randn(m, k, generator=g, device=dev)
    before = cuda_lib.launch_counts()["qmatmul"]
    _close(qmatmul_cuda(x, lin), qmatmul_reference(x, lin))
    assert cuda_lib.launch_counts()["qmatmul"] == before + 1


@pytest.mark.parametrize("fmt,k,n,pack", [
    (GGMLType.Q4_K, 512, 1000, True), (GGMLType.Q8_0, 64, 256, False),
    (GGMLType.Q4_0, 256, 130, True), (GGMLType.Q4_K, 256, 384, False)])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_fused_head_kernel(dev, fmt, k, n, pack, m, x_dtype):
    lin = _lin(fmt, k, n, pack, seed=n).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + m)
    x = (torch.randn(m, k, generator=g, device=dev) * 3).to(x_dtype)
    nw = torch.rand(k, generator=g, device=dev) + 0.5
    ref = fused_linear_reference(lin, x, nw)
    logits = fused_head_cuda(lin, x, nw)
    _close(logits, ref, slack=norm_rounding_slack(lin, x, nw).cpu())
    tok = fused_head_cuda(lin, x, nw, argmax=True)
    assert tok.dtype == torch.int32
    # the argmax epilogue picks the first maximum of the kernel's logits
    assert torch.equal(tok.cpu(), logits.argmax(dim=-1).to(torch.int32).cpu())


def test_fused_head_argmax_ties_first_occurrence(dev):
    n = 1000
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, n)).astype(np.float32)
    big = np.abs(w).max() + 1.0
    for col in (10, 300, 900):  # equal maxima in different blocks
        w[:, col] = big
    lin = QLinear.from_float(w, GGMLType.Q8_0, device="cpu").to(dev)
    x = torch.ones(2, 64, device=dev)
    nw = torch.ones(64, device=dev)
    tok = fused_head_cuda(lin, x, nw, argmax=True).cpu()
    assert tok.tolist() == [10, 10]


@pytest.mark.parametrize("S,Tq,H,Hkv,D,T", [
    (1, 1, 4, 2, 16, 37), (2, 3, 8, 2, 64, 130), (1, 1, 32, 8, 128, 1024),
    (3, 1, 14, 2, 64, 64), (1, 16, 8, 8, 128, 200)])
def test_flash_decode_kernel(dev, S, Tq, H, Hkv, D, T):
    g = torch.Generator(device=dev)
    g.manual_seed(T)
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
    vs = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
    vis = torch.rand(S, Tq, T, generator=g, device=dev) < 0.7
    vis[0, 0] = False  # a row that sees nothing stays finite
    args = (q, kq, ks, vq, vs, vis, 1.0 / D ** 0.5)
    got = flash_decode_cuda(*args)
    assert torch.isfinite(got).all()
    _close(got, flash_decode_quant_reference(*args))


@pytest.mark.parametrize("seen", [1, 100, 700])
def test_flash_decode_skips_unseen_chunks(dev, seen):
    """Rows that all see a prefix of a long cache: the kernel skips the
    chunks past it and still matches the twin, which walks all of T."""
    g = torch.Generator(device=dev)
    g.manual_seed(seen)
    S, Tq, H, Hkv, D, T = 2, 1, 32, 8, 128, 2048
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
    vs = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
    vis = torch.zeros(S, Tq, T, dtype=torch.bool, device=dev)
    vis[:, :, :seen] = True
    vis[1, :, 1500] = True  # a lone visible token far out
    args = (q, kq, ks, vq, vs, vis, 1.0 / D ** 0.5)
    _close(flash_decode_cuda(*args), flash_decode_quant_reference(*args))


def test_forward_cuda_matches_cpu(dev, tmp_path):
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny-k", GGMLType.Q4_K, seed=0,
                             seq_len=64)
    outs = []
    for device in ("cpu", dev):
        cfg, model = load_gguf_model(ws / "model", device=device)
        llm = cfg.llm
        kv = KVCache.create(llm.n_layers, 2, 64, llm.n_kv_heads,
                            llm.head_size, device)
        toks = torch.arange(24, device=device).reshape(2, 12) + 5
        pos = torch.arange(12, device=device).expand(2, 12).clone()
        pos[1, 8:] = -1  # dropped lanes
        a = model(kv, toks, pos, logits_mode="all")
        b = model(kv, toks[:, :1], kv.pos[:, None].long(), logits_mode="last")
        outs.append((a.cpu(), b.cpu(), kv.k.cpu(), kv.pos.cpu()))
    (a0, b0, k0, p0), (a1, b1, k1, p1) = outs
    # bf16 roundings can flip on either side; logits agree to ~1e-3
    _close(a1, a0, rel=2e-2)
    _close(b1, b0, rel=2e-2)
    assert torch.equal(p0, p1)
    assert (k0.int() - k1.int()).abs().max() <= 1
