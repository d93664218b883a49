"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the kernels and the twins do the same f32 arithmetic on the
same bf16-rounded inputs and sum in another order, so they agree to
f32 rounding (relative to the largest output). The fused head also
rounds its normalized rows to bf16 after an f32 norm summed in another
order: an element next to a bf16 rounding midpoint may round the other
way, which ops.fused.norm_rounding_slack bounds per logit; the glu
prologue's silu, with exp on the card, likewise (glu_rounding_slack).
"""

import numpy as np
import pytest
import torch

from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.ops import cuda_lib
from powerserve_tpu_torch.ops.flash_decode import (
    flash_decode_cuda, flash_decode_paged_cuda, flash_decode_paged_reference,
    flash_decode_quant_reference)
from powerserve_tpu_torch.ops.flash_prefill import (
    flash_prefill_cuda, flash_prefill_quant_reference)
from powerserve_tpu_torch.ops.fused import (fused_linear_cuda,
                                            fused_linear_reference,
                                            glu_rounding_slack, launch_name,
                                            norm_rounding_slack)
from powerserve_tpu_torch.ops.qmatmul import (
    QLinear, qmatmul_cuda, qmatmul_grouped_cuda, qmatmul_grouped_reference,
    qmatmul_reference, qmatmul_w8_cuda, qmatmul_w8_grouped_cuda,
    qmatmul_w8_reference, quantize_activations, quantize_activations_cuda)

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
    # N a multiple of 16 (the GEMV's 16-byte copies) but not of its
    # 128-column tile
    (GGMLType.Q4_K, 2048, 1104, True), (GGMLType.Q8_0, 512, 528, False),
]


@pytest.mark.parametrize("fmt,k,n,pack", QMM_CASES)
@pytest.mark.parametrize("m", [1, 3, 5, 8, 16, 17, 70])
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
    (GGMLType.Q4_K, 4096, 4096, True), (GGMLType.Q8_0, 4096, 1024, False),
    (GGMLType.Q4_0, 14336, 512, True)])
@pytest.mark.parametrize("m", [1, 5, 8, 16])
def test_qmatmul_gemv_same_bits_every_run(dev, fmt, k, n, pack, m):
    """The GEMV's K splits add up in a fixed order inside one launch: two
    runs on the same inputs give the same bits, and one launch per
    product."""
    lin = _lin(fmt, k, n, pack, seed=m, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    x = torch.randn(m, k, generator=g, device=dev)
    before = cuda_lib.launch_counts()["qmatmul"]
    a, b = qmatmul_cuda(x, lin), qmatmul_cuda(x, lin)
    assert cuda_lib.launch_counts()["qmatmul"] == before + 2
    assert torch.equal(a, b)
    _close(a, qmatmul_reference(x, lin))


@pytest.mark.parametrize("m,k,n", [(1024, 4096, 6144), (512, 14336, 4096)])
def test_qmatmul_gemm_llama8b_shapes(dev, m, k, n):
    """The prefill GEMM at the scheduler's 8 x 128-row chunk on the QKV
    shape, and at the down projection's K = 14336."""
    lin = _lin(GGMLType.Q4_K, k, n, True, seed=m, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    x = torch.randn(m, k, generator=g, device=dev)
    _close(qmatmul_cuda(x, lin), qmatmul_reference(x, lin))


@pytest.mark.parametrize("fmt,pack", [(GGMLType.Q4_K, True),
                                      (GGMLType.Q8_0, False)])
def test_qmatmul_gemm_same_bits_every_run(dev, fmt, pack):
    """No split of K across blocks: two runs at M = 512 give the same
    bits."""
    lin = _lin(fmt, 4096, 1024, pack, seed=3, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x = torch.randn(512, 4096, generator=g, device=dev)
    a, b = qmatmul_cuda(x, lin), qmatmul_cuda(x, lin)
    assert torch.equal(a, b)
    _close(a, qmatmul_reference(x, lin))


# the inverse CDF's slack: the kernel's block scan and torch.cumsum add
# the f32 values in other orders, so a draw may differ only where u *
# total lies this close to a CDF boundary (the f64 CDF at the smaller of
# the two tokens)
CDF_SLACK = 1e-3


@pytest.mark.parametrize("V", [128256, 152064])
def test_sample_kernel_matches_twin(dev, V):
    """csrc/sample.cu against its twin at [8, V], 16 calls a mode (the
    counters moving on): uniforms and Gumbel noise bit-equal, the
    counters alike; categorical tokens equal but where u * total lies
    within CDF_SLACK of a CDF boundary, at most 1% of the rows. The
    rows: softmax at temperature 1 and 0.3, top-40 and top-p masked,
    one-hot and unnormalized."""
    from powerserve_tpu_torch.ops import sample as sm

    g = torch.Generator(device=dev)
    g.manual_seed(V)
    R = 8
    logits = torch.randn(R, V, generator=g, device=dev) * 3
    dist = torch.softmax(logits, dim=-1)
    dist[1] = torch.softmax(logits[1] / 0.3, dim=-1)
    kth = dist[2].topk(40).values[-1]
    dist[2] = torch.where(dist[2] >= kth, dist[2], 0.0)
    srt = dist[3].sort(descending=True)
    keep = (srt.values.cumsum(0) - srt.values) < 0.9
    dist[3] = torch.zeros_like(dist[3]).scatter(
        0, srt.indices, torch.where(keep, srt.values, 0.0))
    dist[4] = 0.0
    dist[4, V - 7] = 1.0
    dist[5] *= 3.5
    seed = torch.tensor([3, -1, 2 ** 40, 7, 11, 13, 17, 19], device=dev)
    counter = torch.arange(R, device=dev) * 5
    for mode in ("uniform", "gumbel"):
        fn = sm.sample_uniform if mode == "uniform" else sm.sample_gumbel
        ref = (sm.uniform_reference if mode == "uniform"
               else sm.gumbel_reference)
        c1, c2 = counter.clone(), counter.clone()
        for _ in range(16):
            assert torch.equal(fn(seed, c1, R, V), ref(seed, c2, R, V)), mode
        assert torch.equal(c1, c2) and torch.equal(c1, counter + 16)
    c1, c2 = counter.clone(), counter.clone()
    differ = 0
    for _ in range(16):
        c0 = c1.clone()
        got = sm.sample_categorical(dist, seed, c1)
        want = sm.categorical_reference(dist, seed, c2)
        assert (dist.gather(1, got[:, None]) > 0).all()
        assert int(got[4]) == V - 7
        u = sm.unit_floats(sm.draw_words(seed, c0, torch.zeros_like(c0))[:, 0])
        cdf = dist.double().cumsum(dim=-1)
        for r in torch.nonzero(got != want)[:, 0].tolist():
            lo = min(int(got[r]), int(want[r]))
            t = float(u[r]) * float(cdf[r, -1])
            assert abs(float(cdf[r, lo]) - t) < CDF_SLACK, (r, lo, t)
            differ += 1
    assert torch.equal(c1, c2)
    assert differ <= 0.01 * 16 * R, differ
    torch.cuda.synchronize()


def _sync_free(fn):
    """fn() with every host-device synchronization an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# counts a paged scheduler's device-to-host copies over 4 decode ticks,
# in a process of its own: a profiler session over replayed CUDA graphs
# leaves later sessions of the process without device events
TICK_COPIES = r"""
import sys
import torch
from torch.profiler import ProfilerActivity, profile
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.speculative.chain import self_draft_model

cfg, model = load_gguf_model(sys.argv[1], device="cuda")
hp = HyperParams(max_slots=4, batch_size=16, max_seq_len=256,
                 paged_pages=64, page_size=8, prefix_cache=0, spec_k=2)
sched = BatchScheduler(model, cfg, hp, "cuda", draft=self_draft_model(
    model, 1) if sys.argv[2] == "chain" else None)
for i in range(4):
    sched.submit(Request(prompt_ids=list(range(3 + i, 20 + i)),
                         max_tokens=200, temperature=float(sys.argv[3]),
                         seed=i))
warm = 0  # admission, prefill, the eager tick, the capture, a replay
while warm < 3:
    warm += all(s.req is not None and not s.prefilling for s in sched.slots)
    sched.step()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(4):
        sched.step()
    torch.cuda.synchronize()
copies = [e.name for e in prof.events() if e.name.startswith("Memcpy DtoH")]
print(len(copies), sched.pos_host == sched.kv.pos.tolist())
"""


@pytest.mark.parametrize("spec", ["plain", "chain"])
@pytest.mark.parametrize("temperature", ["0.0", "0.8"])
def test_paged_tick_reads_the_card_once(dev, tmp_path, spec, temperature):
    """A paged decode tick, plain or speculative (a 1-layer self-draft),
    greedy or sampled (the draws on the card), copies from the card to
    the host once: its fetch. The page grants read the scheduler's host
    mirror of the positions."""
    import subprocess
    import sys
    from pathlib import Path

    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny", GGMLType.Q8_0, seed=0,
                             seq_len=256)
    out = subprocess.run(
        [sys.executable, "-c", TICK_COPIES, str(ws / "model"), spec,
         temperature],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["4", "True"], out.stdout


@pytest.mark.parametrize("paged", [False, True])
def test_decode_forward_reads_nothing_back(dev, tmp_path, paged):
    """A decode forward (dense, one slot; or the paged pool, 8 slots, one
    inactive, then a deferred verify of 3 rows) issues no host sync, and
    stores what the same forwards on the cpu store."""
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny-k", GGMLType.Q4_K, seed=0,
                             seq_len=64)
    S = 8 if paged else 1
    outs = []
    for device in ("cpu", dev):
        cfg, model = load_gguf_model(ws / "model", device=device)
        llm = cfg.llm
        shape = (llm.n_layers, S, 64, llm.n_kv_heads, llm.head_size, device)
        if paged:
            kv = PagedKVCache.create(*shape, n_pages=40, page_size=8)
            pool = PagePool(40, S, kv.max_pages, 8)
            for s_ in range(S - 1):
                assert pool.ensure(s_, 20)
            pool.flush(kv)
        else:
            kv = KVCache.create(*shape)
        toks = (torch.arange(S * 12, device=device).reshape(S, 12) % 200 + 5)
        pos = torch.arange(12, device=device).expand(S, 12).clone()
        model(kv, toks, pos, logits_mode="none")
        active = torch.ones(S, dtype=torch.bool, device=device)
        active[-1] = not paged
        dpos = torch.where(active, kv.pos.long(), -1)[:, None]
        step = lambda: model(kv, toks[:, :1], dpos, active=active,  # noqa
                             logits_mode="argmax")
        tok = _sync_free(step) if device != "cpu" else step()
        if paged:  # and a deferred verify of 3 rows, as speculation runs it
            vpos = torch.where(active[:, None], kv.pos.long()[:, None]
                               + torch.arange(3, device=device), -1)
            verify = lambda: model(kv, toks[:, :3], vpos, active=active,  # noqa
                                   logits_mode="argmax_all",
                                   kv_update="deferred")
            _sync_free(verify) if device != "cpu" else verify()
        outs.append([t.cpu() for t in (tok, kv.k, kv.v, kv.pos, kv.mask)])
    (t0, k0, v0, p0, m0), (t1, k1, v1, p1, m1) = outs
    assert torch.equal(p0, p1) and torch.equal(m0, m1)
    assert (k0.int() - k1.int()).abs().max() <= 1
    assert (v0.int() - v1.int()).abs().max() <= 1


@pytest.mark.parametrize("paged", [False, True])
def test_cache_create_peak_memory_is_the_cache(dev, paged):
    """Building a cache on the card holds one copy of it at its peak (the
    flat storages with their spare rows, mask, pos, page table), not a
    second one while views are made."""
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.kv.paged import PagedKVCache

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if paged:  # llama-8b's layout, 16 layers, 64 pages of 64
        kv = PagedKVCache.create(16, 8, 2048, 8, 128, dev, n_pages=64,
                                 page_size=64)
        own = [kv.page_table]
    else:
        kv = KVCache.create(16, 2, 2048, 8, 128, dev)
        own = []
    own += [*kv.storage, kv.mask, kv.pos]
    size = sum(t.numel() * t.element_size() for t in own)
    peak = torch.cuda.max_memory_allocated() - base
    # the caching allocator may hand out up to 1 MiB more with a block;
    # a second copy of the storages would add 67 MB
    assert size <= peak <= size + (1 << 20) * len(own)


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
    ref = fused_linear_reference(lin, norm=(x, nw))
    logits = fused_linear_cuda(lin, "norm", [x], nw)
    _close(logits, ref, slack=norm_rounding_slack(lin, x, nw).cpu())
    tok = fused_linear_cuda(lin, "norm", [x], nw, argmax=True)
    assert tok.dtype == torch.int32
    # the argmax epilogue picks the first maximum of the kernel's logits
    assert torch.equal(tok.cpu(), logits.argmax(dim=-1).to(torch.int32).cpu())


def test_fused_head_argmax_ties_first_occurrence(dev):
    n = 1000
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, n)).astype(np.float32)
    big = np.abs(w).max() + 1.0
    # equal maxima in one 128-column tile and in different tiles
    for col in (10, 20, 300, 900):
        w[:, col] = big
    lin = QLinear.from_float(w, GGMLType.Q8_0, device="cpu").to(dev)
    x = torch.ones(2, 64, device=dev)
    nw = torch.ones(64, device=dev)
    tok = fused_linear_cuda(lin, "norm", [x], nw, argmax=True).cpu()
    assert tok.tolist() == [10, 10]
    tok = fused_linear_cuda(lin, "x", [x], argmax=True).cpu()
    assert tok.tolist() == [10, 10]


FUSED_MODES = {
    "x": ("x", 1, False, 0), "x+bias": ("x", 1, True, 0),
    "norm(x+attn)": ("norm", 2, False, 0),
    "norm3+bias": ("norm", 3, True, 0), "glu+2resids": ("glu", 1, False, 2),
    "concat2+bias+resid": ("concat2", 2, True, 1),
}


def _fused_operands(g, dev, mode, m, k, n, dtype):
    pro, n_ops, bias, n_res = FUSED_MODES[mode]
    widths = {"glu": [2 * k], "concat2": [k // 4, k - k // 4]}.get(
        pro, [k] * n_ops)
    ops = [(torch.randn(m, w, generator=g, device=dev) * 2).to(dtype)
           for w in widths]
    nw = torch.rand(k, generator=g, device=dev) + 0.5 if pro == "norm" else None
    b = torch.randn(n, generator=g, device=dev) if bias else None
    res = [(torch.randn(m, n, generator=g, device=dev) * 4).to(dtype)
           for _ in range(n_res)]
    return pro, ops, nw, b, res


@pytest.mark.parametrize("fmt,k,n,pack", [
    (GGMLType.Q4_K, 512, 1000, True), (GGMLType.Q8_0, 256, 384, False),
    (GGMLType.Q4_0, 512, 130, True), (GGMLType.Q4_K, 256, 384, False)])
@pytest.mark.parametrize("m", [1, 5, 8, 16])
@pytest.mark.parametrize("mode", list(FUSED_MODES))
def test_fused_linear_kernel(dev, fmt, k, n, pack, m, mode):
    lin = _lin(fmt, k, n, pack, seed=n + k, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + m)
    dtype = torch.bfloat16 if m == 5 else torch.float32
    pro, ops, nw, b, res = _fused_operands(g, dev, mode, m, k, n, dtype)
    kw = dict(bias=b, resids=res)
    if pro == "norm":
        kw["norm"] = (*ops, nw)
    else:
        kw[{"x": "x", "glu": "glu", "concat2": "parts"}[pro]] = (
            ops[0] if pro != "concat2" else tuple(ops))
    ref = fused_linear_reference(lin, **kw)
    name = launch_name(pro, len(ops), b, res, False)
    before = cuda_lib.launch_counts()[name]
    got = fused_linear_cuda(lin, pro, ops, nw, b, res)
    assert cuda_lib.launch_counts()[name] == before + 1
    slack = 0.0
    if pro == "norm":
        slack = norm_rounding_slack(lin, *ops, nw).cpu()
    elif pro == "glu":
        slack = glu_rounding_slack(lin, ops[0]).cpu()
    _close(got, ref, slack=slack)
    tok = fused_linear_cuda(lin, pro, ops, nw, b, res, argmax=True)
    assert torch.equal(tok.cpu(), got.argmax(dim=-1).to(torch.int32).cpu())


@pytest.mark.parametrize("m", [1, 5, 8, 16])
def test_fused_glu_kernel_at_llama8b_ffn_depth(dev, m):
    """The down projection of llama-8b reads a 2 x 14336 gate|up block (a
    bf16 prologue of up to 16 x 14336 for the GEMV's K splits)."""
    k, n = 14336, 256
    lin = _lin(GGMLType.Q4_K, k, n, True, seed=m, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    gu = torch.randn(m, 2 * k, generator=g, device=dev) * 2
    r0 = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    r1 = torch.randn(m, n, generator=g, device=dev)
    got = fused_linear_cuda(lin, "glu", [gu], resids=[r0, r1])
    ref = fused_linear_reference(lin, glu=gu, resids=(r0, r1))
    _close(got, ref, slack=glu_rounding_slack(lin, gu).cpu())


@pytest.mark.parametrize("mode", list(FUSED_MODES))
@pytest.mark.parametrize("m", [1, 8, 16])
def test_fused_linear_same_bits_every_run(dev, mode, m):
    """The fused GEMV's K splits add up in a fixed order inside their
    cluster: two runs give the same bits, logits and argmax alike."""
    k, n = 4096, 4096
    lin = _lin(GGMLType.Q4_K, k, n, True, seed=7, bf16=True).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    pro, ops, nw, b, res = _fused_operands(g, dev, mode, m, k, n,
                                           torch.float32)
    first = fused_linear_cuda(lin, pro, ops, nw, b, res)
    assert torch.equal(first, fused_linear_cuda(lin, pro, ops, nw, b, res))
    tok = fused_linear_cuda(lin, pro, ops, nw, b, res, argmax=True)
    assert torch.equal(tok, fused_linear_cuda(lin, pro, ops, nw, b, res,
                                              argmax=True))


def _cache(g, dev, S, Hkv, T, D):
    kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
              for _ in range(2))
    return kq, ks, vq, vs


def _close_flips(got, ref, vs, rel=1e-4):
    """Kernel and twin sum the f32 scores in another order, so p * vs,
    rounded to bf16 before the value product, may round the other way
    where it sits next to a rounding midpoint. Each such flip moves a
    whole head row by one bf16 ulp (2^-8) of that term's p / l * |bf16(vs)
    * vq|, and all of them together by at most 2^-8 * 127 * max vs. At
    most 1 in 100 outputs may exceed 1e-4 of the largest output, and none
    by more than that bound."""
    got, ref = got.float().cpu(), ref.float().cpu()
    err = (got - ref).abs()
    tol = rel * max(1.0, ref.abs().max().item())
    flip = 2.0 ** -8 * 127 * vs.float().abs().max().item()
    assert (err > tol).float().mean().item() <= 1e-2, err.max().item()
    assert (err <= tol + flip).all(), (err.max().item(), flip)


@pytest.mark.parametrize("S,Tq,H,Hkv,D,T,starts,committed", [
    (1, 512, 32, 8, 128, 2048, [0], [0]),
    (8, 128, 32, 8, 128, 2048, [-1, 0, 5, 300, 1920, 2047, 2048, 64],
     [0, 0, 5, 300, 0, 900, 0, 64]),
    (2, 40, 8, 2, 64, 333, [0, 290], [0, 290]),
    (2, 24, 4, 2, 16, 100, [3, -1], [3, 0]),
    (3, 70, 4, 4, 32, 250, [0, 17, 180], [0, 17, 0]),
    (2, 33, 14, 2, 64, 129, [1, 96], [1, 50]),
    (1, 17, 64, 8, 128, 64, [0], [0]),
])
def test_flash_prefill_kernel(dev, S, Tq, H, Hkv, D, T, starts, committed):
    g = torch.Generator(device=dev)
    g.manual_seed(T + Tq)
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    # a committed prefix of `committed[s]` positions, plus scattered bits
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(
        committed, device=dev)[:, None]
    mask[-1, T // 2] = True
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    args = (q, kq, ks, vq, vs, mask, start, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_prefill"]
    got = flash_prefill_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_prefill"] == before + 1
    assert torch.isfinite(got).all()
    _close_flips(got, flash_prefill_quant_reference(*args), vs)


def _bucket(dev, long_slot=True):
    """The scheduler's bucket: S = 8, Tq = 128, T = 2048, llama-8b heads;
    with long_slot the last slot has 1900 committed positions (the
    longest walk, which sets the kernel's time), else 190."""
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    S, Tq, H, Hkv, D, T = 8, 128, 32, 8, 128, 2048
    long = 1900 if long_slot else 190
    starts = [0, 128, -1, 512, 40, 1000, -1, long]
    committed = [0, 128, 300, 512, 40, 1000, 0, long]
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(
        committed, device=dev)[:, None]
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    return (q, kq, ks, vq, vs, mask, start, 1.0 / D ** 0.5)


@pytest.mark.parametrize("long_slot", [True, False])
def test_flash_prefill_bucket_with_a_long_slot(dev, long_slot):
    args = _bucket(dev, long_slot)
    got = flash_prefill_cuda(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close_flips(got, flash_prefill_quant_reference(*args), args[4])


def test_flash_prefill_same_bits_every_run(dev):
    """Each row is written by the one block that walks its unit, with no
    atomics: the same bits on every run."""
    args = _bucket(dev)
    a, b = flash_prefill_cuda(*args), flash_prefill_cuda(*args)
    assert torch.equal(a, b)


def test_flash_prefill_row_that_sees_nothing(dev):
    """start = -1 and no committed bit: row 0 sees nothing and averages V
    over all T positions (no chunk is skipped for that block)."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    S, Tq, H, Hkv, D, T = 1, 20, 8, 2, 64, 300
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
    start = torch.tensor([-1], dtype=torch.int32, device=dev)
    args = (q, kq, ks, vq, vs, mask, start, 1.0 / D ** 0.5)
    got = flash_prefill_cuda(*args)
    _close_flips(got, flash_prefill_quant_reference(*args), vs)
    mean_v = (vs.to(torch.bfloat16).float()[..., None]
              * vq.float()).mean(dim=2)  # [S, Hkv, D]
    row0 = got[0, 0].reshape(Hkv, H // Hkv, D)
    _close(row0, mean_v[0, :, None].expand_as(row0))


def _page_table(g, dev, S, MP, P, n_alloc):
    """Each slot owns the first n_alloc[s] logical pages, mapped to
    scrambled pool pages; the rest read P (unallocated)."""
    perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
    pt = torch.full((S, MP), P, dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(n_alloc):
        pt[s, :n] = perm[used:used + n]
        used += n
    return pt


def _mask_positions(g, dev, S, Tq, T, p=0.7):
    """A random cache mask [S, T] and positions [S, Tq] with -1, past T
    and repeats; slot 0 sees nothing at all."""
    mask = torch.rand(S, T, generator=g, device=dev) < p
    pos = torch.randint(0, T, (S, Tq), generator=g, device=dev,
                        dtype=torch.int32)
    if Tq > 1:
        pos[-1, 0] = -1
        pos[-1, -1] = pos[-1, Tq // 2]
    mask[0] = False
    pos[0] = -1
    pos[0, 0] = T
    return mask, pos


@pytest.mark.parametrize("S,Tq,H,Hkv,D,T", [
    (1, 1, 4, 2, 16, 37), (2, 3, 8, 2, 64, 130), (1, 1, 32, 8, 128, 1024),
    (3, 1, 14, 2, 64, 64), (1, 16, 8, 8, 128, 200),
    # every split and token-group count, the head sizes of the presets
    # (16, 64, 128; 40 and 96 pad to the mma's 16), up to 8 row tiles
    (2, 5, 32, 8, 128, 1000), (2, 1, 32, 8, 128, 2048),
    (2, 4, 16, 2, 64, 4096), (2, 16, 16, 2, 128, 2048),
    (2, 7, 14, 2, 64, 300), (2, 2, 4, 2, 16, 4096), (2, 1, 8, 2, 96, 130),
    (2, 2, 4, 1, 40, 77)])
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
    mask, pos = _mask_positions(g, dev, S, Tq, T)
    args = (q, kq, ks, vq, vs, mask, pos, 1.0 / D ** 0.5)
    got = flash_decode_cuda(*args)
    assert torch.isfinite(got).all()  # slot 0's rows see nothing
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
    mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
    mask[:, :seen] = True
    mask[1, 1500] = True  # a lone visible token far out
    pos = torch.full((S, Tq), -1, dtype=torch.int32, device=dev)
    args = (q, kq, ks, vq, vs, mask, pos, 1.0 / D ** 0.5)
    _close(flash_decode_cuda(*args), flash_decode_quant_reference(*args))


def test_flash_decode_one_launch_same_bits(dev):
    """Each mode is one kernel launch (the split merge runs inside it)
    and gives the same bits on every run."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    S, Tq, H, Hkv, D, T, page = 4, 5, 32, 8, 128, 2048, 64
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    mask, pos = _mask_positions(g, dev, S, Tq, T)
    MP = T // page
    pt = _page_table(g, dev, S, MP, S * MP, [MP] * S)
    kp, ksp, vp, vsp = _cache(g, dev, S * MP, Hkv, page, D)
    calls = {
        "flash_decode": lambda: flash_decode_cuda(
            q, kq, ks, vq, vs, mask, pos, 0.1),
        "flash_decode_paged": lambda: flash_decode_paged_cuda(
            q, kp, ksp, vp, vsp, pt, mask, pos, 0.1),
        "flash_decode_paged_state": lambda: flash_decode_paged_cuda(
            q, kp, ksp, vp, vsp, pt, mask, None, 0.1, state=True)[0]}
    for name, fn in calls.items():
        first = fn()
        torch.cuda.synchronize()
        before = cuda_lib.launch_counts()[name]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = fn()
            torch.cuda.synchronize()
        assert cuda_lib.launch_counts()[name] == before + 1
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "flash_decode" in kernels[0], kernels
        assert torch.equal(first, again), name


@pytest.mark.parametrize("page", [8, 16, 64, 128])
@pytest.mark.parametrize("S,Tq,H,Hkv,D,MP_tokens", [
    (8, 1, 32, 8, 128, 2048), (3, 2, 8, 2, 64, 512), (2, 1, 4, 2, 16, 256)])
def test_flash_decode_paged_kernel(dev, page, S, Tq, H, Hkv, D, MP_tokens):
    g = torch.Generator(device=dev)
    g.manual_seed(page + S)
    MP = MP_tokens // page
    filled = [min(MP_tokens - 1, 600 + 37 * s) for s in range(S)]
    n_alloc = [min(MP, -(-(f + 1) // page)) for f in filled]
    P = sum(n_alloc) + 3
    pt = _page_table(g, dev, S, MP, P, n_alloc)
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kp, vp = (torch.randint(-127, 128, (P, Hkv, page, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ksp, vsp = (torch.rand(P, Hkv, page, generator=g, device=dev) * 0.05
                for _ in range(2))
    T = MP * page
    # the committed positions, and the new rows at filled[s] + j (past the
    # allocated pages: clipped, as the pool clips them)
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor(filled, device=dev)[:, None])
    pos = (torch.tensor(filled, device=dev)[:, None]
           + torch.arange(Tq, device=dev)[None, :]).to(torch.int32)
    args = (q, kp, ksp, vp, vsp, pt, mask, pos, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_decode_paged"]
    got = flash_decode_paged_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_decode_paged"] == before + 1
    _close_flips(got, flash_decode_paged_reference(*args), vsp)
    # rows that see nothing read clipped unallocated pages, finite
    mask[0] = False
    pos[0] = -1
    got = flash_decode_paged_cuda(*args)
    assert torch.isfinite(got).all()
    _close_flips(got, flash_decode_paged_reference(*args), vsp)


@pytest.mark.parametrize("S,Tq,page", [(8, 5, 64), (3, 1, 8), (2, 16, 16),
                                       (4, 5, 128)])
def test_flash_decode_paged_state_kernel(dev, S, Tq, page):
    """The state mode against the twin's state: o, m and l in the (h, g,
    tq) row order; the last slot sees no committed position, so its m
    stays at -1e30 and a deferred merge weighs it 0."""
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_paged_deferred)
    from powerserve_tpu_torch.ops.attention import NEG_INF

    g = torch.Generator(device=dev)
    g.manual_seed(S * page + Tq)
    H, Hkv, D, T = 32, 8, 128, 1024
    MP = T // page
    filled = [300 + 41 * s for s in range(S - 1)] + [0]
    n_alloc = [-(-f // page) for f in filled]
    P = sum(n_alloc) + 3
    pt = _page_table(g, dev, S, MP, P, n_alloc)
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kp, vp = (torch.randint(-127, 128, (P, Hkv, page, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ksp, vsp = (torch.rand(P, Hkv, page, generator=g, device=dev) * 0.05
                for _ in range(2))
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor(filled, device=dev)[:, None])
    args = (q, kp, ksp, vp, vsp, pt, mask, None, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_decode_paged_state"]
    o, m, l = flash_decode_paged_cuda(*args, state=True)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_decode_paged_state"] == before + 1
    ro, rm, rl = flash_decode_paged_reference(*args, state=True)
    assert o.shape == (S, H * Tq, D) and m.shape == l.shape == (S, H * Tq)
    seen = torch.tensor([f > 0 for f in filled], device=dev)
    assert (m[~seen] <= NEG_INF / 2).all()
    _close(m[seen], rm[seen], rel=1e-6)
    _close(l[seen], rl[seen], rel=1e-4)
    _close_flips(o[seen], ro[seen], vsp)
    # merged with an in-flight block: the plain merge on the kernel's state
    # against the same merge on the twin's
    knq, vnq = (torch.randint(-127, 128, (S, Hkv, Tq, D), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
    kns, vns = (torch.rand(S, Hkv, Tq, generator=g, device=dev) * 0.05
                for _ in range(2))
    intra = torch.ones(Tq, Tq, dtype=torch.bool, device=dev).tril()
    intra = intra.expand(S, Tq, Tq).contiguous()
    dargs = (*args[:7], knq, kns, vnq, vns, intra, args[8])
    got = flash_decode_paged_deferred(*dargs)
    ref = flash_decode_paged_deferred(*(t.cpu() if torch.is_tensor(t) else t
                                        for t in dargs))
    _close_flips(got, ref, vsp)


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


def _stack(fmt, e, k, n, pack, seed, bf16):
    return QLinear.stack([_lin(fmt, k, n, pack, seed + i, bf16)
                          for i in range(e)])


@pytest.mark.parametrize("fmt,k,n,pack", [
    (GGMLType.Q4_K, 512, 384, True), (GGMLType.Q8_0, 256, 200, False),
    (GGMLType.Q4_0, 256, 130, True), (GGMLType.Q4_K, 256, 96, False)])
@pytest.mark.parametrize("block_m,tiles", [
    (16, [3, 0, 3, 1, 2]), (128, [1, 3, 0]), (1, [2, 0, 1, 1]),
    (8, [0, 3])])
@pytest.mark.parametrize("bf16", [False, True])
def test_qmatmul_grouped_kernel(dev, fmt, k, n, pack, block_m, tiles, bf16):
    """Each tile against its slab; the last tiles pad (they repeat the
    last expert, as group_dispatch's padding does) and must read in
    bounds; an id past the stack clips to the last slab."""
    lin = _stack(fmt, 4, k, n, pack, seed=k + n, bf16=bf16).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + block_m)
    x = torch.randn(len(tiles) * block_m, k, generator=g, device=dev)
    ids = torch.tensor(tiles + [3, 9][:1 + (block_m <= 8)], dtype=torch.int32,
                       device=dev)
    x = torch.cat([x, torch.randn(block_m * (ids.numel() - len(tiles)), k,
                                  generator=g, device=dev)])
    before = cuda_lib.launch_counts()["qmatmul_grouped"]
    got = qmatmul_grouped_cuda(x, lin, ids, block_m)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["qmatmul_grouped"] == before + 1
    _close(got, qmatmul_grouped_reference(x, lin, ids, block_m))
    # tile i is the dense kernel's product with slab ids[i] at the same
    # numerics (f32 weights up to 16 rows, bf16 at 128)
    for i, e in enumerate(ids.clamp(max=3).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        _close(got[rows], qmatmul_reference(x[rows], lin.slab(e)))


# K from one 128-deep block, an odd number of blocks, llama-8b's down
# projection; N ragged (1, 130, 200) and not
W8_GEMV_SHAPES = [(1024, 256), (512, 200), (256, 1), (4096, 640), (128, 130),
                  (384, 200), (14336, 130), (384, 1)]


@pytest.mark.parametrize("k,n", W8_GEMV_SHAPES)
@pytest.mark.parametrize("m", [*range(1, 17), 17, 48, 130])
def test_qmatmul_w8_kernel(dev, k, n, m):
    """Exact int32 block dots on both sides: only the f32 sum over the
    blocks is taken in another order. Every row count of the GEMV (1-16:
    8 and 9 on either side of its second B tile), then the GEMM; the same
    bits on two runs."""
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + m)
    q = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(k // 128, n, generator=g, device=dev) * 0.02 + 0.001
    lin = QLinear(q, s, None, packed=False, unsigned=False, in_features=k,
                  out_features=n, scale_group=128)
    x = torch.randn(m, k, generator=g, device=dev) * 2
    x[0] = 0.0  # a zero row: scale 0, output 0
    before = cuda_lib.launch_counts()["qmatmul_w8"]
    got = qmatmul_w8_cuda(x, lin)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["qmatmul_w8"] == before + 1
    _close(got, qmatmul_w8_reference(x, lin))
    assert not got[0].any()
    assert torch.equal(got, qmatmul_w8_cuda(x, lin))


def _w8_extremes(g, dev, m, k, n, e=None):
    """Rows whose codes are all +-127 (every entry of magnitude 0.75; row 0
    all +127, row 1 all -127) and int8 weights of +-127 and -128 (a whole
    column at -128, one at +127): the largest integer partials a 128-deep
    block holds, 128 * 127 * 128 < 2^24. Returns (x bf16 [m, k], q int8
    [(e,) k, n])."""
    lead = () if e is None else (e,)
    signs = torch.randint(0, 2, (m, k), generator=g, device=dev) * 2 - 1
    signs[0], signs[1 % m] = 1, -1
    x = (signs * 0.75).to(torch.bfloat16)
    vals = torch.tensor([-128, -127, 127], dtype=torch.int8, device=dev)
    q = vals[torch.randint(0, 3, (*lead, k, n), generator=g, device=dev)]
    q[..., 0], q[..., 1 % n] = -128, 127
    return x, q


@pytest.mark.parametrize("k,n", [(128, 130), (384, 200), (14336, 130)])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17])
def test_qmatmul_w8_kernel_extreme_codes(dev, k, n, m):
    """At the extreme codes the tensor cores' s32 block sums must be the
    twin's exact ones: within 2e-5 of the largest output, the same bits
    on two runs."""
    g = torch.Generator(device=dev)
    g.manual_seed(k * 3 + n + m)
    x, q = _w8_extremes(g, dev, m, k, n)
    s = torch.rand(k // 128, n, generator=g, device=dev) * 0.02 + 0.001
    lin = QLinear(q, s, None, packed=False, unsigned=False, in_features=k,
                  out_features=n, scale_group=128)
    x8, _ = quantize_activations(x)
    assert x8.abs().eq(127).all()
    got = qmatmul_w8_cuda(x, lin)
    _close(got, qmatmul_w8_reference(x, lin))
    assert torch.equal(got, qmatmul_w8_cuda(x, lin))


def _w8_lin(g, dev, k, n):
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(k // 128, n, generator=g, device=dev) * 0.02 + 0.001
    return QLinear(q, s, None, packed=False, unsigned=False, in_features=k,
                   out_features=n, scale_group=128)


@pytest.mark.parametrize("n", [1, 130, 200])
@pytest.mark.parametrize("k", [128, 4096, 14336])
@pytest.mark.parametrize("m", [17, 40, 64, 128, 512, 1024])
def test_qmatmul_w8_gemm_shapes(dev, m, k, n):
    """The W8 prefill GEMM at ragged M and N, K from one 128-deep block
    up: against the twin, and the same bits on two runs."""
    g = torch.Generator(device=dev)
    g.manual_seed(m * 7 + k + n)
    lin = _w8_lin(g, dev, k, n)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    got = qmatmul_w8_cuda(x, lin)
    _close(got, qmatmul_w8_reference(x, lin))
    assert torch.equal(got, qmatmul_w8_cuda(x, lin))


def _a8_rows(g, dev, m, k):
    """Rows that reach the quantize pass's edges: exact halves that round
    to even (absmax 127, so 1 / scale is 1), a zero row, one nonzero value,
    large and tiny magnitudes, then random rows."""
    x = torch.randn(m, k, generator=g, device=dev) * 3
    x[0] = 0.0
    x[1, :4] = torch.tensor([0.5, -0.5, 2.5, -3.5])
    x[1, 4:] = 0.0
    x[1, 5] = 127.0
    x[2] = 0.0
    x[2, k // 3] = -7.25
    x[3] *= 1e30
    x[4] *= 1e-30
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(5, 128), (16, 4096), (33, 14336)])
@pytest.mark.parametrize("offset", [0, 1])
def test_w8_quantize_pass_bit_equal(dev, m, k, dtype, offset):
    """The kernel's quantize pass gives quantize_activations' codes and
    scales bit for bit, from bf16 or f32 rows, 16-byte aligned or not."""
    g = torch.Generator(device=dev)
    g.manual_seed(m + k)
    x = _a8_rows(g, dev, m, k).to(dtype)
    if offset:
        x = torch.cat([x.flatten()[:offset], x.flatten()])[offset:]
        x = x.view(m, k)
        assert x.data_ptr() % 16
    x8, sx = quantize_activations_cuda(x)
    want8, want_sx = quantize_activations(x.to(torch.bfloat16))
    assert torch.equal(x8, want8)
    assert torch.equal(sx, want_sx)
    assert x8[1, :4].tolist() == [0, 0, 2, -4] and x8[1, 5] == 127


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (5, 14336, 4096),
                                   (16, 1024, 640), (40, 4096, 640),
                                   (512, 128, 200)])
def test_qmatmul_w8_two_kernels_a_product(dev, m, k, n):
    """A W8 product is two kernels, the quantize pass and the product (K
    splits add up inside a cluster: no reduce kernel), one count, and the
    same bits on every run."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev)
    g.manual_seed(m + k + n)
    lin = _w8_lin(g, dev, k, n)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    first = qmatmul_w8_cuda(x, lin)
    torch.cuda.synchronize()
    before = cuda_lib.launch_counts()["qmatmul_w8"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = qmatmul_w8_cuda(x, lin)
        torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["qmatmul_w8"] == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert "w8_quantize" in kernels[0] and "w8_" in kernels[1], kernels
    assert not any("reduce" in name for name in kernels), kernels
    assert torch.equal(first, again)


def _w8_stack(g, dev, e, k, n):
    return QLinear.stack([_w8_lin(g, dev, k, n) for _ in range(e)])


W8_GROUPED_CASES = [
    (k, n, block_m, tiles)
    for k, n in ((512, 384), (256, 200), (4096, 130), (128, 1))
    for block_m, tiles in ((16, [3, 0, 3, 1, 2]), (128, [1, 3, 0]),
                           (1, [2, 0, 1, 1]), (8, [0, 3]), (5, [1, 2]))
] + [(384, 200, block_m, [1, 2, 0]) for block_m in range(1, 17)] + [
    (14336, 130, 16, [2, 0]), (14336, 130, 9, [1])]


@pytest.mark.parametrize("k,n,block_m,tiles", W8_GROUPED_CASES)
def test_qmatmul_w8_grouped_kernel(dev, k, n, block_m, tiles):
    """The grouped mode of the W8 kernel: each tile against the twin on
    its slab, padding tiles that repeat the last expert and an id past the
    stack (clipped to the last slab), every tile height of the GEMV
    (1-16), K of one, three and 112 blocks, ragged N; one count, the same
    bits on two runs."""
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + block_m)
    lin = _w8_stack(g, dev, 4, k, n)
    ids = torch.tensor(tiles + [3, 9], dtype=torch.int32, device=dev)
    x = torch.randn(ids.numel() * block_m, k, generator=g,
                    device=dev).to(torch.bfloat16)
    x[0] = 0.0  # a zero row: scale 0, output 0
    before = cuda_lib.launch_counts()["qmatmul_w8_grouped"]
    got = qmatmul_w8_grouped_cuda(x, lin, ids, block_m)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["qmatmul_w8_grouped"] == before + 1
    _close(got, qmatmul_grouped_reference(x, lin, ids, block_m))
    for i, e in enumerate(ids.clamp(max=3).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        _close(got[rows], qmatmul_w8_reference(x[rows], lin.slab(e)))
    assert not got[0].any()
    assert torch.equal(got, qmatmul_w8_grouped_cuda(x, lin, ids, block_m))


@pytest.mark.parametrize("k,n", [(384, 200), (14336, 130)])
@pytest.mark.parametrize("block_m", [1, 2, 8, 16])
def test_qmatmul_w8_grouped_kernel_extreme_codes(dev, k, n, block_m):
    """The grouped mode at the extreme codes (see
    test_qmatmul_w8_kernel_extreme_codes), an id past the stack."""
    g = torch.Generator(device=dev)
    g.manual_seed(k + n + block_m)
    ids = torch.tensor([2, 0, 7], dtype=torch.int32, device=dev)
    x, q = _w8_extremes(g, dev, ids.numel() * block_m, k, n, e=3)
    s = torch.rand(3, k // 128, n, generator=g, device=dev) * 0.02 + 0.001
    lin = QLinear(q, s, None, packed=False, unsigned=False, in_features=k,
                  out_features=n, scale_group=128)
    got = qmatmul_w8_grouped_cuda(x, lin, ids, block_m)
    _close(got, qmatmul_grouped_reference(x, lin, ids, block_m))
    assert torch.equal(got, qmatmul_w8_grouped_cuda(x, lin, ids, block_m))


@pytest.mark.parametrize("block_m,p", [(1, 2), (16, 64), (128, 256)])
def test_qmatmul_w8_grouped_two_kernels_a_product(dev, block_m, p):
    """A grouped W8 product is the quantize pass over all rows and one
    product kernel (GEMV or GEMM)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev)
    g.manual_seed(block_m)
    lin = _w8_stack(g, dev, 8, 1024, 512)
    x = torch.randn(p, 1024, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, 8, (p // block_m,), generator=g, device=dev,
                        dtype=torch.int32)
    qmatmul_w8_grouped_cuda(x, lin, ids, block_m)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        qmatmul_w8_grouped_cuda(x, lin, ids, block_m)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert "w8_quantize" in kernels[0] and "w8_" in kernels[1], kernels


def test_w8_moe_forward_cuda_matches_cpu(dev):
    """A W8 MoE model (make_device_params, W8 expert slabs) through the
    single-token, GEMV-tile and MMA-tile routes on the card and on the
    cpu, with the grouped W8 kernel launched on every route."""
    import copy

    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.llama import moe_route
    from powerserve_tpu_torch.tools import synthetic
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    synthetic.PRESETS.setdefault("w8-moe-test", dict(
        dim=256, ffn=256, layers=2, heads=4, kv_heads=2, vocab=512,
        arch="llama", bias=False, experts=4, experts_used=2))
    cfg, cpu_model = make_device_params("w8-moe-test", "w8", 0, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    llm = cfg.llm
    for S, T in ((1, 70), (8, 3), (1, 1)):
        outs = []
        for device, model in (("cpu", cpu_model), (dev, gpu_model)):
            kv = KVCache.create(llm.n_layers, S, 128, llm.n_kv_heads,
                                llm.head_size, device)
            toks = (torch.arange(S * T, device=device).reshape(S, T)
                    * 7 % 500 + 3)
            pos = torch.arange(T, device=device).expand(S, T).clone()
            before = cuda_lib.launch_counts()["qmatmul_w8_grouped"]
            outs.append(model(kv, toks, pos, logits_mode="all").cpu())
            if device != "cpu":
                launched = (cuda_lib.launch_counts()["qmatmul_w8_grouped"]
                            - before)
                assert launched == 3 * llm.n_layers, (moe_route(S * T),
                                                      launched)
        # an int8 rounding of an activation may flip on either side
        _close(outs[1], outs[0], rel=3e-2)


def test_moe_forward_cuda_matches_cpu(dev, tmp_path):
    """tiny-moe through each route on the card and on the cpu; each MoE
    FFN runs without a host sync."""
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.llama import moe_route
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    outs = {}
    for name, kw in (("e4", {}), ("e64", dict(experts=64))):
        ws = make_synthetic_gguf(tmp_path / name, "tiny-moe", GGMLType.Q8_0,
                                 seed=1, seq_len=128, **kw)
        for device in ("cpu", dev):
            cfg, model = load_gguf_model(ws / "model", device=device)
            llm = cfg.llm
            res = []
            for S, T in ((1, 70), (8, 3), (1, 1)):
                kv = KVCache.create(llm.n_layers, S, 128, llm.n_kv_heads,
                                    llm.head_size, device)
                toks = (torch.arange(S * T, device=device).reshape(S, T)
                        * 7 % 250 + 3)
                pos = torch.arange(T, device=device).expand(S, T).clone()
                layer = model.layers[0]
                h = torch.randn(S * T, llm.dim, device=device,
                                generator=torch.Generator(device).manual_seed(
                                    0)).to(torch.bfloat16)
                if device != "cpu":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        layer.moe_ffn(h, llm.n_experts_used)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                res.append((moe_route(S * T),
                            model(kv, toks, pos, logits_mode="all").cpu()))
            outs[name, str(device)] = res
        for (ra, a), (rb, b) in zip(outs[name, "cpu"], outs[name, str(dev)]):
            assert ra == rb
            _close(b, a, rel=2e-2)
    routes = {r for rs in outs.values() for r, _ in rs}
    assert {r for r, _ in routes} == {"single", "grouped"}
    assert ("grouped", 16) in routes and ("grouped", 128) in routes


def test_w8_forward_cuda_matches_cpu(dev, tmp_path):
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny-k", GGMLType.Q4_K, seed=0,
                             seq_len=64)
    outs = []
    for device in ("cpu", dev):
        cfg, model = load_gguf_model(ws / "model", device=device, mxu=True)
        llm = cfg.llm
        kv = KVCache.create(llm.n_layers, 2, 64, llm.n_kv_heads,
                            llm.head_size, device)
        toks = torch.arange(40, device=device).reshape(2, 20) + 5
        pos = torch.arange(20, device=device).expand(2, 20).clone()
        before = cuda_lib.launch_counts()
        a = model(kv, toks, pos, logits_mode="all")
        b = model(kv, toks[:, :1], kv.pos[:, None].long(), logits_mode="last")
        after = cuda_lib.launch_counts()
        if device != "cpu":
            assert after["qmatmul_w8"] > before["qmatmul_w8"]
            assert after["fused_head"] == before["fused_head"]
        outs.append((a.cpu(), b.cpu()))
    (a0, b0), (a1, b1) = outs
    # an int8 rounding of an activation may flip on either side (1/127 of
    # its row's largest value): logits agree to ~1e-2 of the range
    _close(a1, a0, rel=3e-2)
    _close(b1, b0, rel=3e-2)


def test_chain_spec_engine_cuda_matches_plain(dev, tmp_path):
    """One greedy ChainSpecEngine run on the card (a 1-layer self-draft:
    the fused layer chain and the fused head at M = 1, a verify of k + 1
    rows) against the plain engine's tokens on the card (near-tie rule),
    with every new fused mode launched."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.speculative.chain import ChainSpecEngine
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny-k", GGMLType.Q4_K, seed=0,
                             seq_len=128)
    cfg, model = load_gguf_model(ws / "model", device=dev)
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    plain = InferenceEngine(model, cfg, hp, device=dev)
    prompt = [3, 17, 5, 9, 44, 12]
    want = list(plain.generate(prompt, 20))
    before = cuda_lib.launch_counts()
    spec = ChainSpecEngine(model, cfg, self_draft_layers=1, k=3,
                           block_steps=4, max_seq=128, device=dev)
    got = list(spec.generate(prompt, 20))
    after = cuda_lib.launch_counts()
    for name in ("fused_head", "fused_x", "fused_norm", "fused_glu",
                 "qmatmul", "flash_decode"):
        assert after[name] > before[name], name
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is not None:
        plain.reset()
        top2 = plain.prefill(prompt + want[:i]).topk(2).values
        assert float(top2[0] - top2[1]) < 0.5, (i, got, want)


# -- the decode steps replayed as CUDA graphs (engine/graphs.py) --------------


def _graph_model(tmp_path, preset, dev):
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    quant = GGMLType.Q4_K if preset == "tiny-k" else GGMLType.Q8_0
    ws = make_synthetic_gguf(tmp_path, preset, quant, seed=0, seq_len=128)
    return load_gguf_model(ws / "model", device=dev)


def _eager_steps():
    """Every StepGraph runs its body eagerly: the replayed paths' twin."""
    from unittest import mock

    from powerserve_tpu_torch.engine.graphs import StepGraph

    return mock.patch.object(StepGraph, "__call__", StepGraph.eager)


def _same_cache_bits(a, b):
    for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _replays_without_sync(graphs):
    """One more replay of every captured step of `graphs`, with every
    host-device synchronization an error."""
    captured = [g for g in graphs.graphs.values() if g.graph is not None]
    assert captured
    for g in captured:
        g.bufs["step"].zero_()  # the outputs' first column again
        _sync_free(g)


def _counted(fn):
    cuda_lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_lib.launch_counts()


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
def test_decode_scan_replay_matches_eager(dev, tmp_path, preset):
    """Replayed decode_scan against decode_scan_eager on copies of one
    cache (3 slots at different positions): the same tokens, the cache
    bit for bit, the same launch counts; then a replay without a host
    sync."""
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.engine.loops import (decode_scan,
                                                   decode_scan_eager)
    from powerserve_tpu_torch.kv.cache import KVCache

    cfg, model = _graph_model(tmp_path, preset, dev)
    llm = cfg.llm
    a = KVCache.create(llm.n_layers, 3, 128, llm.n_kv_heads, llm.head_size,
                       dev)
    toks = torch.arange(3 * 12, device=dev).reshape(3, 12) * 7 % 200 + 3
    pos = torch.arange(12, device=dev).expand(3, 12).clone()
    pos[1, 5:] = -1
    model(a, toks, pos, logits_mode="none")
    b = a.clone()
    for n in (9, 7):  # the second call replays from its first step
        got, counts = _counted(lambda: decode_scan(model, toks[:, -1], a, n))
        want, eager = _counted(
            lambda: decode_scan_eager(model, toks[:, -1], b, n))
        assert torch.equal(got, want)
        _same_cache_bits(a, b)
        assert counts == eager
    _replays_without_sync(graphs_of(a))


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_engine_blocks_replay_match_eager(dev, tmp_path, preset,
                                         temperature):
    """InferenceEngine.generate with replayed blocks (whole steps, the
    sampled draw through csrc/sample.cu inside the graph) against the
    same engine settings with every step eager: the same tokens, a
    stop mid-block rolled back alike, the cache and the penalty window
    bit for bit, the same launch counts."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine

    cfg, model = _graph_model(tmp_path, preset, dev)

    def engine():
        hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=128,
                         decode_horizon=4)
        hp.sampler.temperature = temperature
        hp.sampler.seed = 3
        hp.sampler.penalty_repeat = 1.2
        return InferenceEngine(model, cfg, hp, eos_id=2, device=dev)

    prompt = [3, 17, 5, 9, 44, 12]

    def runs(eng, stop_at=None):
        out = []
        for stop in (None, None, stop_at):
            eng.reset(1)
            out.append(list(eng.generate(
                prompt, 14, slot=1,
                stop_fn=None if stop is None else lambda t: t == stop)))
        return out

    got, want = engine(), engine()
    ids, counts = _counted(lambda: runs(got))
    ids_stop = runs(got, stop_at=ids[0][5])
    with _eager_steps():
        twin, eager = _counted(lambda: runs(want))
        twin_stop = runs(want, stop_at=ids[0][5])
    assert ids == twin and ids_stop == twin_stop
    assert counts == eager
    if temperature == 0.0:
        assert ids_stop[2] == ids[0][:len(ids_stop[2])]
        assert len(ids_stop[2]) <= 6
    _same_cache_bits(got.kv, want.kv)
    assert torch.equal(got.penalty.recent, want.penalty.recent)
    _replays_without_sync(got.graphs)


def _sched_requests(temperature):
    return [dict(prompt_ids=[1, 4, 9, 11], temperature=0.0, logprobs=3),
            dict(prompt_ids=list(range(3, 20)), temperature=0.0,
                 penalty_repeat=1.4, penalty_freq=0.3),
            dict(prompt_ids=[5, 5, 5, 6], temperature=temperature, top_k=12,
                 seed=11, logprobs=2),
            dict(prompt_ids=[7, 8], temperature=0.0)]


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_scheduler_ticks_replay_match_eager(dev, tmp_path, preset, paged,
                                           temperature):
    """Three decode ticks of the scheduler (horizon 3; dense cache or
    paged pool; a slot at 0.8 draws through csrc/sample.cu inside the
    graph) replayed against the same ticks with every step eager:
    tokens, logprobs and top logprobs, the cache and the penalty window
    bit for bit, the same launch counts (the draws' included)."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request

    cfg, model = _graph_model(tmp_path, preset, dev)

    def sched():
        hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=128,
                         decode_horizon=3, paged_pages=24 if paged else 0,
                         page_size=8)
        s = BatchScheduler(model, cfg, hp, device=dev)
        for r in _sched_requests(temperature):
            s.submit(Request(max_tokens=40, **r))
        s._admit()
        while s._prefill_tick():
            pass
        return s

    got, want = sched(), sched()
    outs = ("out_tok", "out_lp", "out_ti", "out_tlp")
    for _ in range(3):
        _, counts = _counted(got._decode_tick)
        with _eager_steps():
            _, eager = _counted(want._decode_tick)
        for name in outs:
            assert torch.equal(got.bufs[name], want.bufs[name]), name
        assert counts == eager
        _same_cache_bits(got.kv, want.kv)
        assert torch.equal(got.penalty.recent, want.penalty.recent)
    got._drain()  # the last tick's results (double-buffered ticks)
    want._drain()
    logprobs = [len(sl.req.token_logprobs) for sl in got.slots
                if sl.req is not None and sl.req.logprobs]
    assert logprobs and all(n == 9 for n in logprobs)
    _replays_without_sync(got.graphs)


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_ticks_replay_match_eager(dev, tmp_path, preset, paged,
                                      temperature):
    """Three spec ticks of the scheduler (a 1-layer self-draft, k = 3,
    two steps a tick; dense cache or paged pool, whose verify takes the
    deferred route; greedy, or with a slot at 0.8 whose draws go through
    csrc/sample.cu inside the graph) replayed against the same ticks
    eager: the same emitted tokens and counts, both caches bit for bit,
    the same launch counts."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
    from powerserve_tpu_torch.speculative.chain import self_draft_model

    cfg, model = _graph_model(tmp_path, preset, dev)

    def sched():
        hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=128,
                         spec_k=3, spec_horizon=2,
                         paged_pages=40 if paged else 0, page_size=8)
        s = BatchScheduler(model, cfg, hp, device=dev,
                           draft=self_draft_model(model, 1))
        for r in _sched_requests(temperature):
            s.submit(Request(max_tokens=60, **r))
        s._admit()
        while s._prefill_tick():
            pass
        return s

    got, want = sched(), sched()
    for _ in range(3):
        _, counts = _counted(got._decode_tick)
        with _eager_steps():
            _, eager = _counted(want._decode_tick)
        for name in ("spec_emitted", "spec_counts", "root"):
            assert torch.equal(got.bufs[name], want.bufs[name]), name
        assert counts == eager
        _same_cache_bits(got.kv, want.kv)
        _same_cache_bits(got.d_kv, want.d_kv)
    got._drain()  # the last tick's results (double-buffered ticks)
    want._drain()
    assert got.n_spec_steps == want.n_spec_steps == 3 * 2 * 4
    _replays_without_sync(got.graphs)


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
@pytest.mark.parametrize("draft", ["self:1", "separate"])
def test_chain_steps_replay_match_eager(dev, tmp_path, preset, draft):
    """Replayed chain_spec_scan (k = 3, two slots) against the same steps
    eager: tokens, counts and root, both caches bit for bit, the same
    launch counts; then a replay without a host sync."""
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.speculative.chain import (chain_spec_scan,
                                                        self_draft_model)

    cfg, model = _graph_model(tmp_path / "t", preset, dev)
    d_model = (self_draft_model(model, 1) if draft == "self:1"
               else _graph_model(tmp_path / "d", preset, dev)[1])
    S, k = 2, 3

    def prefilled(m):
        llm = m.llm
        kv = KVCache.create(llm.n_layers, S, 128, llm.n_kv_heads,
                            llm.head_size, dev)
        toks = torch.arange(S * 9, device=dev).reshape(S, 9) * 5 % 200 + 3
        pos = torch.arange(9, device=dev).expand(S, 9).clone()
        pos[0, 6:] = -1
        m(kv, toks, pos, logits_mode="none")
        return kv

    t1, d1 = prefilled(model), prefilled(d_model)
    t2, d2 = t1.clone(), d1.clone()
    root = torch.tensor([7, 9], device=dev)
    r1 = r2 = root
    for n in (5, 4):
        (tok1, c1, r1), counts = _counted(
            lambda: chain_spec_scan(model, d_model, t1, d1, r1, n, k))
        with _eager_steps():
            (tok2, c2, r2), eager = _counted(
                lambda: chain_spec_scan(model, d_model, t2, d2, r2, n, k))
        assert torch.equal(tok1, tok2) and torch.equal(c1, c2)
        assert torch.equal(r1, r2)
        assert counts == eager
        _same_cache_bits(t1, t2)
        _same_cache_bits(d1, d2)
    _replays_without_sync(graphs_of(t1))


def test_deleting_an_engine_frees_its_graph_pool(dev, tmp_path):
    """An engine's captured graphs hold a memory pool; deleting the
    engine gives it back (memory_reserved after empty_cache returns to
    what it was before the engine)."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.graphs import pool_bytes

    cfg, model = _graph_model(tmp_path, "tiny-k", dev)
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0

    def run():
        eng = InferenceEngine(model, cfg, hp, device=dev)
        assert len(list(eng.generate([3, 17, 5, 9], 12))) == 12
        return eng

    first = run()  # every lazy allocation of the path, once
    del first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    eng = run()
    assert any(g.graph is not None for g in eng.graphs.graphs.values())
    held = pool_bytes(eng.graphs)
    assert held > 0
    assert torch.cuda.memory_reserved(dev) >= base + held
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) == base


def test_capture_beside_an_unreachable_graph(dev):
    """A captured graph whose owner is left in a reference cycle, then a
    capture whose body allocates enough objects for an automatic garbage
    collection: the collection is held off until the capture ends
    (destroying the old graph inside the capture would invalidate it),
    the new step replays right, and the old graph goes at the next
    collection."""
    import gc
    import weakref

    from powerserve_tpu_torch.engine.graphs import StepGraphs

    x = torch.zeros(4, device=dev)
    old = StepGraphs(dev)
    step = old.step(("add",), lambda: (lambda: x.add_(1), {}))
    step()
    step()  # captured, then replayed
    assert step.graph is not None
    gone = weakref.ref(old)

    def body():
        junk = [[] for _ in range(4 * gc.get_threshold()[0])]
        del junk
        return x.mul_(2)

    new = StepGraphs(dev)
    g = new.step(("mul",), lambda: (body, {}))
    g()  # eager: (1 + 1) * 2
    gc.collect()
    holder = {"graphs": old}
    holder["self"] = holder  # the old graphs reachable only from a cycle
    del old, step, holder
    g()  # captured (the cycle's collection held off), then replayed
    assert g.graph is not None and gone() is not None
    g()
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.full((4,), 16.0))
    gc.collect()
    assert gone() is None


# -- token-tree speculation: the tree mode of flash-decode and the replayed
# tree steps ----------------------------------------------------------------


def _tree_case(g, dev, S, N_keys, starts, T, inactive=()):
    """A committed prefix [0, starts[s]) per slot and key positions
    starts[s] + j (j < N_keys); an inactive slot's keys are -1."""
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor(starts, device=dev)[:, None])
    keys = (torch.tensor(starts, device=dev)[:, None]
            + torch.arange(N_keys, device=dev)[None, :]).to(torch.int32)
    for s in inactive:
        keys[s] = -1
    return mask, keys


def _tree_rows(widths, level=None):
    """A template's intra rows: the verify's ancestor rows [N, N], or a
    draft level's [len(level), N]."""
    from powerserve_tpu_torch.speculative.device_tree import TreeTemplate

    tpl = TreeTemplate.from_widths(widths)
    anc = torch.from_numpy(tpl.anc)
    return anc if level is None else anc[torch.from_numpy(
        tpl.levels[level]).long()]


@pytest.mark.parametrize("S,H,Hkv,D,T", [(1, 32, 8, 128, 2048),
                                         (3, 8, 2, 64, 300),
                                         (8, 32, 8, 128, 1024)])
@pytest.mark.parametrize("rows", ["verify", "level1", "level2", "random",
                                  "rows20", "rows28", "rows32", "rows36",
                                  "rows64"])
@pytest.mark.parametrize("widths", [[2, 1, 1], [2, 2, 1]])
def test_flash_decode_tree_kernel(dev, S, H, Hkv, D, T, rows, widths):
    """The tree mode against its twin (the paged mode's tolerance: a
    p * vs next to a bf16 midpoint may round the other way): a verify's
    ancestor rows, a draft level's rows over all nodes, and random bit
    rows over 32 keys with repeated, -1 and past-T positions (16 rows a
    kv head's 4 heads, or "rowsR": G * Tq = R rows, on both sides of 32,
    the most one warp holds); an inactive slot; one launch of the tree
    counter; the same bits twice."""
    from powerserve_tpu_torch.ops.flash_decode import pack_intra

    g = torch.Generator(device=dev)
    g.manual_seed(S * T + len(rows))
    N = _tree_rows(widths).shape[0]
    starts = [min(T - 40, 500 + 61 * s) for s in range(S)]
    if rows.startswith("r"):
        J = 32
        Tq = 16 if rows == "random" else int(rows[4:]) // (H // Hkv)
        intra = torch.rand(Tq, J, generator=g, device=dev) < 0.3
        mask, keys = _tree_case(g, dev, S, J, starts, T)
        keys[:, 5] = keys[:, 3]
        keys[:, 9] = -1
        keys[:, 11] = T + 2
    else:
        intra = (_tree_rows(widths) if rows == "verify"
                 else _tree_rows(widths, int(rows[-1])))
        Tq = intra.shape[0]
        mask, keys = _tree_case(g, dev, S, N, starts, T,
                                inactive=(S - 1,) if S > 1 else ())
    bits = pack_intra(intra.to(dev))
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    args = (q, kq, ks, vq, vs, mask, keys, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_decode_tree"]
    got = flash_decode_cuda(*args, bits=bits)
    again = flash_decode_cuda(*args, bits=bits)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_decode_tree"] == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    _close_flips(got, flash_decode_quant_reference(*args, bits=bits), vs)


@pytest.mark.parametrize("Tq,H,Hkv,D", [(1, 32, 8, 128), (5, 32, 8, 128),
                                        (16, 8, 2, 64), (7, 4, 1, 40),
                                        (7, 32, 8, 128), (8, 32, 8, 128),
                                        (9, 32, 8, 128), (16, 32, 8, 128),
                                        (5, 8, 2, 64), (8, 8, 2, 64),
                                        (9, 8, 2, 64)])
def test_flash_decode_causal_rows_keep_their_bits(dev, Tq, H, Hkv, D):
    """The causal rule is the tree mode with lower-triangular rows: both
    give the bits of today's call, dense and paged, twice, within the
    flips rule of the twin; G * Tq from 4 to 64 rows, on both sides of
    32, the most one warp holds."""
    from powerserve_tpu_torch.ops.flash_decode import pack_intra

    g = torch.Generator(device=dev)
    g.manual_seed(Tq * D)
    S, T, page = 3, 1024, 64
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _cache(g, dev, S, Hkv, T, D)
    mask, pos = _mask_positions(g, dev, S, Tq, T)
    causal = pack_intra(torch.ones(Tq, Tq, dtype=torch.bool,
                                   device=dev).tril())
    args = (q, kq, ks, vq, vs, mask, pos, 0.1)
    got = flash_decode_cuda(*args)
    assert torch.equal(flash_decode_cuda(*args, bits=causal), got)
    assert torch.equal(flash_decode_cuda(*args), got)
    _close_flips(got, flash_decode_quant_reference(*args), vs)
    MP = T // page
    pt = _page_table(g, dev, S, MP, S * MP, [MP] * S)
    kp, ksp, vp, vsp = _cache(g, dev, S * MP, Hkv, page, D)
    pargs = (q, kp, ksp, vp, vsp, pt, mask, pos, 0.1)
    assert torch.equal(flash_decode_paged_cuda(*pargs, bits=causal),
                       flash_decode_paged_cuda(*pargs))


@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("rows", ["verify", "level1", "rows20", "rows32",
                                  "rows36", "rows64"])
def test_flash_decode_paged_tree_kernel(dev, page, rows):
    """The paged tree mode against its twin: 8 slots, a [2, 1, 1] tree
    over 560-650 positions (its verify's or a draft level's rows, or
    "rowsR": R / 4 random bit rows over its 7 keys, G * Tq = R on both
    sides of 32, the most one warp holds), scrambled pages, an inactive
    slot."""
    from powerserve_tpu_torch.ops.flash_decode import pack_intra

    g = torch.Generator(device=dev)
    g.manual_seed(page)
    S, H, Hkv, D, MP_tokens = 8, 32, 8, 128, 2048
    if rows.startswith("rows"):
        intra = torch.rand(int(rows[4:]) // (H // Hkv), 7, generator=g,
                           device=dev) < 0.4
    else:
        intra = (_tree_rows([2, 1, 1]) if rows == "verify"
                 else _tree_rows([2, 1, 1], 1)).to(dev)
    Tq, N = intra.shape
    MP = MP_tokens // page
    starts = [560 + 13 * s for s in range(S)]
    n_alloc = [-(-(c + N) // page) for c in starts]
    P = sum(n_alloc) + 3
    pt = _page_table(g, dev, S, MP, P, n_alloc)
    kp, ksp, vp, vsp = _cache(g, dev, P, Hkv, page, D)
    mask, keys = _tree_case(g, dev, S, N, starts, MP * page, inactive=(3,))
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    bits = pack_intra(intra)
    args = (q, kp, ksp, vp, vsp, pt, mask, keys, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_decode_paged_tree"]
    got = flash_decode_paged_cuda(*args, bits=bits)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_decode_paged_tree"] == before + 1
    assert torch.equal(got, flash_decode_paged_cuda(*args, bits=bits))
    _close_flips(got, flash_decode_paged_reference(*args, bits=bits), vsp)


@pytest.mark.parametrize("preset", ["tiny", "tiny-k"])
@pytest.mark.parametrize("draft", ["self:1", "separate"])
def test_tree_steps_replay_match_eager(dev, tmp_path, preset, draft):
    """Replayed greedy tree_spec_scan ([2, 1, 1], two slots, one of them
    inactive in the second call) against the same steps eager: tokens,
    counts and root, both caches bit for bit, the same launch counts
    (the tree mode's among them); then a replay without a host sync."""
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.speculative.chain import self_draft_model
    from powerserve_tpu_torch.speculative.device_tree import (TreeTemplate,
                                                              tree_spec_scan)

    cfg, model = _graph_model(tmp_path / "t", preset, dev)
    d_model = (self_draft_model(model, 1) if draft == "self:1"
               else _graph_model(tmp_path / "d", preset, dev)[1])
    tpl = TreeTemplate.from_widths([2, 1, 1])
    S = 2

    def prefilled(m):
        llm = m.llm
        kv = KVCache.create(llm.n_layers, S, 128, llm.n_kv_heads,
                            llm.head_size, dev)
        toks = torch.arange(S * 9, device=dev).reshape(S, 9) * 5 % 200 + 3
        pos = torch.arange(9, device=dev).expand(S, 9).clone()
        pos[0, 6:] = -1
        m(kv, toks, pos, logits_mode="none")
        return kv

    t1, d1 = prefilled(model), prefilled(d_model)
    t2, d2 = t1.clone(), d1.clone()
    r1 = r2 = torch.tensor([7, 9], device=dev)
    for n, act in ((5, [True, True]), (4, [False, True])):
        active = torch.tensor(act, device=dev)
        (tok1, c1, r1), counts = _counted(lambda: tree_spec_scan(
            model, d_model, t1, d1, r1, n, tpl, active))
        with _eager_steps():
            (tok2, c2, r2), eager = _counted(lambda: tree_spec_scan(
                model, d_model, t2, d2, r2, n, tpl, active))
        assert torch.equal(tok1, tok2) and torch.equal(c1, c2)
        assert torch.equal(r1, r2)
        assert counts == eager and counts["flash_decode_tree"] > 0
        _same_cache_bits(t1, t2)
        _same_cache_bits(d1, d2)
    _replays_without_sync(graphs_of(t1))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("wor", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tree_ticks_replay_match_eager(dev, tmp_path, paged, wor,
                                      temperature):
    """Three tree ticks of the scheduler, greedy or with a slot at 0.8
    (its draws, Gumbel noise for WOR, inside the graph) (spec_tree "2,1", a
    1-layer self-draft, two steps a tick; the dense cache or the paged
    pool, whose verify takes the deferred route with the ancestor rows)
    replayed against the same ticks eager: the same emitted tokens and
    counts, both caches bit for bit, the same launch counts."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
    from powerserve_tpu_torch.speculative.chain import self_draft_model

    cfg, model = _graph_model(tmp_path, "tiny-k", dev)

    def sched():
        hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=128,
                         spec_tree="2,1", spec_wor=wor, spec_horizon=2,
                         paged_pages=40 if paged else 0, page_size=8)
        s = BatchScheduler(model, cfg, hp, device=dev,
                           draft=self_draft_model(model, 1))
        for r in _sched_requests(temperature):
            s.submit(Request(max_tokens=60, **r))
        s._admit()
        while s._prefill_tick():
            pass
        return s

    got, want = sched(), sched()
    for _ in range(3):
        _, counts = _counted(got._decode_tick)
        with _eager_steps():
            _, eager = _counted(want._decode_tick)
        for name in ("spec_emitted", "spec_counts", "root"):
            assert torch.equal(got.bufs[name], want.bufs[name]), name
        assert counts == eager
        _same_cache_bits(got.kv, want.kv)
        _same_cache_bits(got.d_kv, want.d_kv)
    got._drain()  # the last tick's results (double-buffered ticks)
    want._drain()
    assert got.n_spec_steps == want.n_spec_steps == 3 * 2 * 4
    _replays_without_sync(got.graphs)


def test_device_tree_engine_cuda_matches_plain(dev, tmp_path):
    """Greedy DeviceTreeEngine runs on the card ([2, 1, 1]; a 1-layer
    self-draft and a separate draft) against the plain engine's tokens
    on the card (near-tie rule), through the tree mode of flash-decode."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.speculative.device_tree import DeviceTreeEngine

    cfg, model = _graph_model(tmp_path / "t", "tiny-k", dev)
    _, d_model = _graph_model(tmp_path / "d", "tiny-k", dev)
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    plain = InferenceEngine(model, cfg, hp, device=dev)
    prompt = [3, 17, 5, 9, 44, 12]
    want = list(plain.generate(prompt, 20))
    for kw in (dict(self_draft_layers=1), dict(draft=d_model)):
        before = cuda_lib.launch_counts()["flash_decode_tree"]
        got = list(DeviceTreeEngine(model, cfg, block_steps=4, max_seq=128,
                                    device=dev, **kw).generate(prompt, 20))
        assert cuda_lib.launch_counts()["flash_decode_tree"] > before
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if i is not None:
            plain.reset()
            top2 = plain.prefill(prompt + want[:i]).topk(2).values
            assert float(top2[0] - top2[1]) < 0.5, (i, got, want)


# -- EAGLE speculation: the head's fused route and the replayed steps ---------


def _eagle_pair(tmp_path, dev, preset="tiny-k"):
    """(cfg, target, head) on `dev`: a synthetic target and a random
    EAGLE-1 head at its widths (no attn_norm on layer 0, an fc bias)."""
    from powerserve_tpu_torch.models.loader import load_eagle_gguf
    from powerserve_tpu_torch.tools.synthetic import make_eagle_gguf

    cfg, model = _graph_model(tmp_path / "t", preset, dev)
    h = make_eagle_gguf(tmp_path / "eagle", preset, seed=9)
    _, head = load_eagle_gguf(h, model, cfg.llm, device=dev)
    return cfg, model, head


@pytest.mark.parametrize("mode", ["all", "argmax"])
def test_eagle_forward_fused_matches_twin(dev, tmp_path, mode):
    """eagle_forward's fused route on the card (the fc through concat2 +
    bias, layer 0's QKV through x + bias, the fused layer chain, the
    head through x (+ argmax)) against the same forward on the cpu: a
    9-token prefill, then 3 rows of 2 slots; logits (or tokens, near-tie
    rule) and features within 2% of their range (the bf16 roundings of
    the layer's inputs may fall apart between the two: REL for one
    kernel, compounded by a layer); the concat2 and x + bias launches
    counted; no host sync."""
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.speculative.eagle import eagle_forward

    outs = {}
    for device in ("cpu", dev):
        cfg, model, head = _eagle_pair(tmp_path / str(device).replace(
            ":", ""), device)
        e = head.llm
        kv = KVCache.create(1, 2, 128, e.n_kv_heads, e.head_size, device)
        g = torch.Generator().manual_seed(3)
        res = []
        for t, p0, m in ((9, 0, "none"), (3, 9, mode)):
            toks = torch.randint(3, 500, (2, t), generator=g).to(device)
            feats = torch.randn(2, t, e.dim, generator=g).to(device)
            pos = (p0 + torch.arange(t)).expand(2, t).to(device)
            if device == "cpu" or m == "none":
                out = eagle_forward(head, kv, toks, feats, pos, logits_mode=m)
            else:
                before = cuda_lib.launch_counts()
                out = _sync_free(lambda: eagle_forward(
                    head, kv, toks, feats, pos, logits_mode=m))
                after = cuda_lib.launch_counts()
                assert after["fused_concat2"] == before["fused_concat2"] + 1
                assert after["fused_x"] > before["fused_x"]
            res.append(tuple(o.cpu() for o in out))
        outs[str(device)] = res
    (_, fc), (lc, fc2) = outs["cpu"]
    (_, fg), (lg, fg2) = outs[str(dev)]
    _close(fg, fc, rel=2e-2)
    _close(fg2, fc2, rel=2e-2)
    if mode == "all":
        _close(lg, lc, rel=2e-2)
    else:
        assert lg.dtype == torch.int32 and lg.shape == (2,)


@pytest.mark.parametrize("tree", [None, [2, 1]])
def test_eagle_steps_replay_match_eager(dev, tmp_path, tree):
    """Replayed greedy eagle_spec_scan (k = 3) or eagle_tree_spec_scan
    ([2, 1]), two slots, one of them inactive in the second call, against
    the same steps eager: tokens, counts, roots and features, both
    caches bit for bit, the same launch counts (concat2 among them);
    then a replay without a host sync."""
    from powerserve_tpu_torch.engine.graphs import graphs_of
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.speculative.device_tree import TreeTemplate
    from powerserve_tpu_torch.speculative.eagle import (eagle_forward,
                                                        eagle_spec_scan,
                                                        eagle_tree_spec_scan)

    cfg, model, head = _eagle_pair(tmp_path, dev)
    S = 2

    def prefilled():
        llm, e = model.llm, head.llm
        t_kv = KVCache.create(llm.n_layers, S, 128, llm.n_kv_heads,
                              llm.head_size, dev)
        e_kv = KVCache.create(1, S, 128, e.n_kv_heads, e.head_size, dev)
        toks = torch.arange(S * 9, device=dev).reshape(S, 9) * 5 % 200 + 3
        pos = torch.arange(9, device=dev).expand(S, 9).clone()
        pos[0, 6:] = -1
        _, f = model(t_kv, toks, pos, logits_mode="none",
                     return_final_hidden=True)
        f = f.float()
        eagle_forward(head, e_kv, toks, torch.cat(
            [torch.zeros_like(f[:, :1]), f[:, :-1]], dim=1), pos,
            logits_mode="none")
        return t_kv, e_kv, f[torch.arange(S), torch.tensor([5, 8])]

    def scan(t_kv, e_kv, root, feat, n, active):
        if tree is None:
            return eagle_spec_scan(model, head, t_kv, e_kv, root, feat, n, 3,
                                   active)
        return eagle_tree_spec_scan(model, head, t_kv, e_kv, root, feat, n,
                                    TreeTemplate.from_widths(tree), active)

    t1, e1, f1 = prefilled()
    t2, e2, f2 = t1.clone(), e1.clone(), f1.clone()
    r1 = r2 = torch.tensor([7, 9], device=dev)
    for n, act in ((5, [True, True]), (4, [False, True])):
        active = torch.tensor(act, device=dev)
        (tok1, c1, r1, f1), counts = _counted(
            lambda: scan(t1, e1, r1, f1, n, active))
        with _eager_steps():
            (tok2, c2, r2, f2), eager = _counted(
                lambda: scan(t2, e2, r2, f2, n, active))
        for a, b in ((tok1, tok2), (c1, c2), (r1, r2), (f1, f2)):
            assert torch.equal(a, b)
        assert counts == eager and counts["fused_concat2"] > 0
        _same_cache_bits(t1, t2)
        _same_cache_bits(e1, e2)
    _replays_without_sync(graphs_of(t1))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("spec_tree", ["", "2,1"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_eagle_ticks_replay_match_eager(dev, tmp_path, paged, spec_tree,
                                       temperature):
    """Three EAGLE ticks of the scheduler, greedy or with a slot at 0.8
    drawing inside the graph (a chain of 3 or the
    [2, 1] tree, two steps a tick; the dense cache or the paged pool)
    replayed against the same ticks eager: emitted tokens, counts, roots
    and carried features, both caches bit for bit, the same launch
    counts."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request

    cfg, model, head = _eagle_pair(tmp_path, dev)

    def sched():
        hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=128,
                         spec_k=3, spec_tree=spec_tree, spec_horizon=2,
                         paged_pages=40 if paged else 0, page_size=8)
        s = BatchScheduler(model, cfg, hp, device=dev, eagle_head=head)
        for r in _sched_requests(temperature):
            s.submit(Request(max_tokens=60, **r))
        s._admit()
        while s._prefill_tick():
            pass
        return s

    got, want = sched(), sched()
    for _ in range(3):
        _, counts = _counted(got._decode_tick)
        with _eager_steps():
            _, eager = _counted(want._decode_tick)
        for name in ("spec_emitted", "spec_counts", "root", "feat"):
            assert torch.equal(got.bufs[name], want.bufs[name]), name
        assert counts == eager and counts["fused_concat2"] > 0
        _same_cache_bits(got.kv, want.kv)
        _same_cache_bits(got.d_kv, want.d_kv)
    got._drain()  # the last tick's results (double-buffered ticks)
    want._drain()
    assert got.n_spec_steps == want.n_spec_steps == 3 * 2 * 4
    _replays_without_sync(got.graphs)


def test_eagle_engine_cuda_matches_plain(dev, tmp_path):
    """Greedy EagleChainEngine runs on the card (a chain of 3 and the
    [2, 1, 1] tree) against the plain engine's tokens on the card
    (near-tie rule), with concat2 launched."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.speculative.device_tree import TreeTemplate
    from powerserve_tpu_torch.speculative.eagle import EagleChainEngine

    cfg, model, head = _eagle_pair(tmp_path, dev)
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    plain = InferenceEngine(model, cfg, hp, device=dev)
    prompt = [3, 17, 5, 9, 44, 12]
    want = list(plain.generate(prompt, 20))
    for tpl in (None, TreeTemplate.from_widths([2, 1, 1])):
        before = cuda_lib.launch_counts()["fused_concat2"]
        got = list(EagleChainEngine(model, cfg, head, k=3, block_steps=4,
                                    max_seq=128, template=tpl,
                                    device=dev).generate(prompt, 20))
        assert cuda_lib.launch_counts()["fused_concat2"] > before
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if i is not None:
            plain.reset()
            top2 = plain.prefill(prompt + want[:i]).topk(2).values
            assert float(top2[0] - top2[1]) < 0.5, (i, got, want)


# -- the vision-language path -------------------------------------------------

# the tower's bf16 products on the card and on the CPU sum in other orders,
# so a bf16 rounding may fall the other way (2^-8 of one element) and
# carry through the layers; the f32 parts agree to f32 rounding
VISION_REL = 2e-2


@pytest.mark.parametrize("preset,layers,tiles", [("tiny-vit", 2, 3),
                                                 ("internvit-300m", 2, 1)])
def test_vision_encode_cuda_matches_cpu(dev, preset, layers, tiles):
    """The tower and projector on the card against the same weights on
    the CPU (InternViT-300M's widths cut to 2 layers, one 448 tile)."""
    from powerserve_tpu_torch.models.vit import (encode_images,
                                                 vision_params_from_hf)
    from powerserve_tpu_torch.tools.synthetic import (VISION_PRESETS,
                                                      random_vision_state)

    v = VISION_PRESETS[preset]
    sd = random_vision_state(preset, 256, seed=1)
    sd = {k: a for k, a in sd.items()
          if ".encoder.layer." not in k
          or int(k.split(".encoder.layer.")[1].split(".")[0]) < layers}
    px = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (tiles, 3, v["image"], v["image"])).astype(np.float32))
    outs = []
    for device in ("cpu", dev):
        vp = vision_params_from_hf(sd, layers, v["heads"], v["patch"],
                                   v["eps"], v["downsample"], device=device)
        outs.append(encode_images(vp, px.to(device)))
    assert outs[1].shape == (tiles, (v["image"] // v["patch"]) ** 2 // 4, 256)
    assert torch.isfinite(outs[1]).all()
    _close(outs[1], outs[0], rel=VISION_REL)


def test_vlm_prefill_reads_nothing_back(dev, tmp_path):
    """A multimodal prefill (the tower, the overlay, the forward) on the
    card issues no host sync and gives the CPU's logits; VLMEngine's
    greedy tokens on the card are the CPU's (near-tie rule)."""
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.vlm import VLMEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.internvl import internvl_from_workspace
    from powerserve_tpu_torch.tools.synthetic import make_vlm_workspace

    ws = make_vlm_workspace(tmp_path, "tiny-vlm", GGMLType.Q8_0, seq_len=128)
    rng = np.random.default_rng(3)
    px = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
    img = rng.integers(0, 256, (50, 120, 3), dtype=np.uint8)
    logits, tokens = [], []
    for device in ("cpu", dev):
        m = internvl_from_workspace(ws / "model", device=device)
        ids = torch.tensor(m.expand_image_tokens([1, 5, 250, 9, 11], 3),
                           device=device)
        llm = m.cfg.llm
        kv = KVCache.create(llm.n_layers, 1, 128, llm.n_kv_heads,
                            llm.head_size, device)
        x = torch.from_numpy(px).to(device)
        if device == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            logits.append(m.prefill_multimodal(kv, ids, x).cpu()
                          if device == "cpu" else
                          m.prefill_multimodal(kv, ids, x))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng = VLMEngine(m, HyperParams(max_seq_len=128), device=device)
        tokens.append(list(eng.generate([1, 5, 250, 9], [img], 8)))
    got, ref = logits[1].cpu(), logits[0]
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-2 * (ref.max() - ref.min())
    assert len(tokens[1]) == 8
    i = next((j for j, (a, b) in enumerate(zip(*tokens)) if a != b), None)
    if i is not None:  # the CPU's teacher-forced top-2 gap at the parting
        m = internvl_from_workspace(ws / "model", device="cpu")
        eng = VLMEngine(m, HyperParams(max_seq_len=128), device="cpu")
        full = m.expand_image_tokens([1, 5, 250, 9],
                                     eng.pixel_values([img]).shape[0])
        kv = KVCache.create(m.cfg.llm.n_layers, 1, 128, m.cfg.llm.n_kv_heads,
                            m.cfg.llm.head_size, "cpu")
        top2 = m.prefill_multimodal(kv, full + tokens[0][:i],
                                    eng.pixel_values([img]))[0].topk(2)
        assert float(top2.values[0] - top2.values[1]) < 0.5


# -- tensor parallelism: the kernels at llama-8b's tp = 2 local shapes ------
# (each rank: 16/4 heads, FFN 7168, vocab 64128), and a rank group of two
# over gloo on the one card


@pytest.mark.parametrize("k,n", [(4096, 3072), (2048, 4096), (4096, 14336),
                                 (7168, 4096)])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_qmatmul_tp2_local_shapes(dev, k, n, m):
    """The GEMV and the prefill GEMM on each rank's projections; down's
    local K = 7168 packs in groups of 1792, which only tp = 2 gives."""
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    g = torch.Generator(device=dev)
    g.manual_seed(k + n + m)
    lin = _rand_qlinear(g, k, n, "q4_k", dev)
    assert lin.pack_group == (1792 if k == 7168 else 2048)
    x = torch.randn(m, k, generator=g, device=dev)
    a = qmatmul_cuda(x, lin)
    assert torch.equal(a, qmatmul_cuda(x, lin))
    _close(a, qmatmul_reference(x, lin))


@pytest.mark.parametrize("m", [1, 4])
def test_fused_head_tp2_local_vocab(dev, m):
    """The head over half of llama-8b's vocab (64128 columns), its logits
    and its argmax (the first maximum of the logits)."""
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    g = torch.Generator(device=dev)
    g.manual_seed(m)
    head = _rand_qlinear(g, 4096, 64128, "q4_k", dev)
    nw = torch.rand(4096, generator=g, device=dev) + 0.5
    h = (torch.randn(m, 4096, generator=g, device=dev) * 3).to(torch.bfloat16)
    logits = fused_linear_cuda(head, "norm", [h], nw)
    _close(logits, fused_linear_reference(head, norm=(h, nw)),
           slack=norm_rounding_slack(head, h, nw).cpu())
    tok = fused_linear_cuda(head, "norm", [h], nw, argmax=True)
    assert torch.equal(tok, logits.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("S,Tq,T", [(1, 1, 1024), (8, 1, 700), (1, 512, 2048)])
def test_flash_attention_tp2_heads(dev, S, Tq, T):
    """Flash-decode (Tq = 1) and flash-prefill (512 rows from 0) at one
    rank's 16/4 heads."""
    H, Hkv, D = 16, 4, 128
    g = torch.Generator(device=dev)
    g.manual_seed(S + Tq)
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
              for _ in range(2))
    scale = D ** -0.5
    if Tq == 1:
        mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
        mask[:, :T - 1] = True
        pos = torch.full((S, 1), T - 1, dtype=torch.int32, device=dev)
        args = (q, kq, ks, vq, vs, mask, pos, scale)
        got = flash_decode_cuda(*args)
        ref = flash_decode_quant_reference(*args)
    else:
        mask = torch.zeros(S, T, dtype=torch.bool, device=dev)
        start = torch.zeros(S, dtype=torch.int32, device=dev)
        args = (q, kq, ks, vq, vs, mask, start, scale)
        got = flash_prefill_cuda(*args)
        ref = flash_prefill_quant_reference(*args)
    # the flash-decode tests' rule: 1e-4 of the range, and rare bf16
    # flips of p * vs (at most 2^-8 * 127 * max vs)
    err = (got.float() - ref.float()).abs()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (err > tol).float().mean() <= 1e-2
    assert (err <= tol + 2.0 ** -8 * 127 * vs.max().item()).all()


def test_tp_forward_over_two_ranks_on_the_card(dev, tmp_path):
    """tiny-k Q4_K over two ranks (gloo, both on this card): a prefill and
    a decode step within 1e-2 of the range of the single device's
    logits (partial sums added in another order, bf16 roundings then
    carried), greedy tokens the single device's (near-tie rule), and
    every rank launched the kernels."""
    from powerserve_tpu_torch.engine.loops import decode_scan_eager
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.parallel.tp import (start_rank_group,
                                                  tp_decode_scan, tp_prefill)
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny-k", GGMLType.Q4_K, seed=0,
                             seq_len=128) / "model"
    cfg, model = load_gguf_model(ws, device=dev)
    llm = cfg.llm
    group = start_rank_group(2, "gloo", dev)
    try:
        _, tm = group.load(ws, 2)
        kv1 = KVCache.create(llm.n_layers, 2, 128, llm.n_kv_heads,
                             llm.head_size, dev)
        kv2 = tm.create_cache(llm.n_layers, 2, 128, llm.n_kv_heads,
                              llm.head_size)
        g = torch.Generator(device="cpu")
        g.manual_seed(0)
        toks = torch.randint(0, llm.vocab_size, (2, 40), generator=g).to(dev)
        pos = torch.arange(40, device=dev)[None].expand(2, -1)
        group.launch_counts(reset=True)
        got = tp_prefill(tm, toks, pos, kv2)
        want = model(kv1, toks, pos, logits_mode="last")
        assert (got - want).abs().max() <= 1e-2 * (want.max() - want.min())
        first = want.argmax(-1)
        a = tp_decode_scan(tm, first, kv2, 8)
        b = decode_scan_eager(model, first, kv1, 8)
        counts = group.launch_counts()
        for c in counts:
            for k in ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode"):
                assert c[k] > 0, (k, counts)
        for s in range(2):  # a parting only at the single's near tie
            i = next((j for j in range(8) if a[s, j] != b[s, j]), None)
            if i is None:
                continue
            seq = toks[s].tolist() + [int(first[s])] + b[s, :i].tolist()
            kv = KVCache.create(llm.n_layers, 1, 128, llm.n_kv_heads,
                                llm.head_size, dev)
            top2 = model(kv, torch.tensor([seq], device=dev),
                         torch.arange(len(seq), device=dev)[None],
                         logits_mode="last")[0].topk(2).values
            assert float(top2[0] - top2[1]) < 0.5
    finally:
        group.close()


# -- KV-prefix persistence and multi-model eviction --------------------------


def test_loaded_prefix_is_bit_exact_and_the_replayed_block_reads_it(
        dev, tmp_path):
    """save_prefix from the card, then load_prefix into the same engine's
    cache after its decode block was captured: the slot holds the saved
    codes and scales bit for bit, the cache keeps its storage, and the
    replayed block after the load gives the eager twin's tokens and
    cache bits (a load that made a new cache would leave the captured
    graph reading the old one)."""
    import numpy as np

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.kv.persist import load_prefix, save_prefix

    cfg, model = _graph_model(tmp_path, "tiny-k", dev)
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    path = tmp_path / "p.npz"

    def run(eng):
        first = list(eng.generate([1, 40, 41, 42, 43, 44, 45], 9))
        if not path.exists():
            save_prefix(eng.kv, path)
        ptrs = [t.data_ptr() for t in eng.kv.storage]
        eng.reset()
        n = load_prefix(eng.kv, path)
        assert [t.data_ptr() for t in eng.kv.storage] == ptrs
        z = np.load(path)
        for name in ("k", "v", "k_scale", "v_scale"):
            got = getattr(eng.kv, name)[:, 0, :, :n].cpu().numpy()
            assert np.array_equal(got, z[name]), name
        return first, list(eng.generate([1, 60, 61, 62], 12))

    got = InferenceEngine(model, cfg, hp, device=dev)
    ids, counts = _counted(lambda: run(got))
    assert any(g.graph is not None for g in got.graphs.graphs.values())
    want = InferenceEngine(model, cfg, hp, device=dev)
    with _eager_steps():
        twin, eager = _counted(lambda: run(want))
    assert ids == twin and counts == eager
    _same_cache_bits(got.kv, want.kv)


def test_evicting_a_model_context_gives_its_memory_back(dev, tmp_path):
    """ServerContext(max_models=1) over two model dirs, each served in
    turn: an eviction stops the idle context and drops its weights, its
    paged pool, its step graphs' pool and its pinned snapshot, so the
    allocated bytes with one context resident come back to the same
    value at every swap (the reserved ones within 5%), and no segment of
    the evicted graphs' pool is left."""
    import shutil
    import time

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import Request
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    root = tmp_path / "root"
    make_synthetic_gguf(root / "a", "tiny-k", GGMLType.Q4_K, seed=0,
                        seq_len=128)
    for f in (root / "a" / "model").iterdir():
        f.rename(root / "a" / f.name)
    shutil.copytree(root / "a", root / "b")
    hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=128,
                     paged_pages=32, page_size=8)
    ctx = ServerContext(root, "a", hp, dev, max_models=1)

    def serve(name):
        sched = ctx.get(name).scheduler
        sched.pin_prefix(list(range(3, 23)))
        done = []
        sched.submit(Request(prompt_ids=list(range(3, 24)), max_tokens=12,
                             temperature=0.0,
                             sink=lambda t: t is None and done.append(1)))
        for _ in range(2000):
            if done:
                break
            time.sleep(0.01)
        assert done and len(sched.prefix_cache.pinned) == 1
        return sched

    try:
        seen = []
        for name in ("a", "b", "a", "b", "a"):
            sched = serve(name)
            pool = tuple(sched.graphs.pool)
            assert any(g.graph is not None
                       for g in sched.graphs.graphs.values())
            del sched
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            seen.append((torch.cuda.memory_allocated(dev),
                         torch.cuda.memory_reserved(dev), pool))
        assert list(ctx.models) == ["a"]
        # from the second swap on, one context of the same size resident:
        # the same allocated bytes, the reserved ones within 5%
        assert len({s[0] for s in seen[1:]}) == 1, seen
        reserved = [s[1] for s in seen[1:]]
        assert max(reserved) <= 1.05 * min(reserved), seen
        for *_, pool in seen[:-1]:  # every evicted context's graph pool
            assert not any(tuple(seg["segment_pool_id"]) == pool
                           for seg in torch.cuda.memory_snapshot())
    finally:
        ctx.close()


def _plain_forward_routes():
    """The forward's kernel calls (models/llama.py) sent to their plain
    twins on the card, for mock.patch.multiple."""
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_paged_reference)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_quant_reference)

    def plain_qmm(x, lin):
        y = qmatmul_reference(x.reshape(-1, x.shape[-1]), lin)
        return y.reshape(*x.shape[:-1], lin.out_features)

    return dict(qmatmul=plain_qmm, qmatmul_grouped=qmatmul_grouped_reference,
                fused_linear=fused_linear_reference,
                flash_decode_quant=flash_decode_quant_reference,
                flash_decode_paged=flash_decode_paged_reference,
                flash_prefill_quant=flash_prefill_quant_reference)


# perplexity on the kernels against the plain twins on the card: a row's
# log-probability moves by at most twice its logits' error (the logit of
# the token and the log-sum), ~1e-3 of their range; each row within 1%
# of its magnitude, so the log-perplexity, their mean, within 1% of its
# own (on random weights ln ppl reaches ~70, and a relative gap of the
# perplexity itself scales with it)
LOGP_SHARE = 1e-2


@pytest.mark.parametrize("preset", ["tiny", "llama-1b"])
def test_perplexity_kernels_match_twins(dev, preset):
    """token_log_probs over 74 tokens at batch 32 (chunks of 32, 32 and
    10: the prefill kernels, then the decode ones) on the kernels and on
    the plain twins on the card; the path launches all four kernels."""
    from unittest import mock

    import powerserve_tpu_torch.models.llama as llama
    from powerserve_tpu_torch.tools.bench_params import make_device_params
    from powerserve_tpu_torch.tools.perplexity import (PerplexityCalculator,
                                                       token_log_probs)

    cfg, model = make_device_params(preset, "q4_k", seed=0, device=dev)
    if preset == "llama-1b":
        model.layers = model.layers[:4]
        model.llm.n_layers = 4
    ids = np.random.default_rng(0).integers(
        3, cfg.llm.vocab_size, 74).tolist()
    cuda_lib.reset_launch_counts()
    got = token_log_probs(model, ids, 32, max_seq=128)
    counts = cuda_lib.launch_counts()
    for name in ("qmatmul", "flash_prefill", "flash_decode", "fused_head"):
        assert counts.get(name, 0) > 0, (name, counts)
    with mock.patch.multiple(llama, **_plain_forward_routes()):
        cuda_lib.reset_launch_counts()
        want = token_log_probs(model, ids, 32, max_seq=128)
        assert not any(cuda_lib.launch_counts().values())
    assert got.shape == want.shape == (73,) and np.isfinite(got).all()
    assert (np.abs(got - want) <= LOGP_SHARE * np.abs(want)).all(), \
        np.abs(got - want).max()
    ppl = []
    for lp in (got, want):
        calc = PerplexityCalculator(32)
        calc.add_log_probs(lp)
        ppl.append(np.log(calc.ppl))
    assert abs(ppl[0] - ppl[1]) <= LOGP_SHARE * ppl[1], ppl


def test_return_hidden_leaves_replayed_decode_steps_alone(dev, tmp_path):
    """A prefill with return_hidden=True gives the plain prefill's logits
    and cache bits; the decode_scan replayed after it launches the same
    kernels and gives the same tokens and cache bits as after the plain
    prefill; the hidden states are the residual stream's."""
    from powerserve_tpu_torch.engine.loops import decode_scan
    from powerserve_tpu_torch.kv.cache import KVCache

    cfg, model = _graph_model(tmp_path, "tiny-k", dev)
    llm = cfg.llm
    toks = torch.arange(2 * 20, device=dev).reshape(2, 20) * 7 % 200 + 3
    pos = torch.arange(20, device=dev).expand(2, 20).clone()
    pos[1, 13:] = -1
    runs = []
    for hidden in (False, True):
        kv = KVCache.create(llm.n_layers, 2, 128, llm.n_kv_heads,
                            llm.head_size, dev)
        out = model(kv, toks, pos, logits_mode="all", return_hidden=hidden)
        logits, h = out if hidden else (out, None)
        steps = []
        for n in (9, 7):  # captured, then replayed
            steps.append(_counted(
                lambda: decode_scan(model, toks[:, -1], kv, n)))
        runs.append((logits, h, kv, steps))
    (l0, _, kv0, s0), (l1, h1, kv1, s1) = runs
    assert torch.equal(l0, l1)
    _same_cache_bits(kv0, kv1)
    for (t0, c0), (t1, c1) in zip(s0, s1):
        assert torch.equal(t0, t1) and c0 == c1
    assert h1.shape == (llm.n_layers, 2, 20, llm.dim)
    assert h1.dtype == torch.bfloat16 and torch.isfinite(h1.float()).all()


# -- the dense state modes: a sequence-parallel rank's slice of the cache --


def _slice_state(dev, g, S, Hkv, T, D):
    kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.05
              for _ in range(2))
    return kq, ks, vq, vs


def _held_state(got, ref, seen, vs):
    """A state (o, m, l) against the twin's: rows that see the slice
    within f32 rounding (o: the flips rule), the others m = -1e30,
    l = 0, o = 0 exactly."""
    from powerserve_tpu_torch.ops.attention import NEG_INF

    (o, m, l), (ro, rm, rl) = got, ref
    assert (m[~seen] == NEG_INF).all() and (l[~seen] == 0).all()
    assert (o[~seen] == 0).all()
    _close(m[seen], rm[seen], rel=1e-6)
    _close(l[seen], rl[seen], rel=1e-4)
    _close_flips(o[seen], ro[seen], vs)


@pytest.mark.parametrize("Tq,t0,tree,H,Hkv,D", [
    (1, 2048, False, 32, 8, 128), (1, 0, False, 32, 8, 128),
    (5, 2048, False, 32, 8, 128), (7, 2048, True, 32, 8, 128),
    (7, 0, True, 32, 8, 128), (5, 2048, True, 32, 8, 128),
    (8, 2048, True, 32, 8, 128), (9, 2048, True, 32, 8, 128),
    (16, 0, True, 32, 8, 128), (9, 2048, True, 8, 2, 64),
    (7, 0, True, 8, 2, 64)],
    ids=["1-2048", "1-0", "5-2048", "tree-7-2048", "tree-7-0",
         "tree-5-2048", "tree-8-2048", "tree-9-2048", "tree-16-0",
         "tree-9-2048-d64", "tree-7-0-d64"])
def test_flash_decode_state_kernel(dev, Tq, t0, tree, H, Hkv, D):
    """The dense state mode over a 2,048-position slice that starts at
    global position t0, at llama-8b's heads or 8/2 heads of 64: slot 0
    decodes past the slice's start, slot 1 deep in it, slot 2 (its
    positions on the other rank) sees none of it. The tree cases: a
    [2, 1, 1] verify (the bit rows of its ancestors over its 7 nodes' key
    positions) or, at other Tq, lower-triangular bit rows (G * Tq = 20 to
    64 rows, on both sides of 32, the most one warp holds); slot 0's
    nodes from 3 before the slice's start (its first rows see none of
    the slice) or, at t0 = 0, from 3 before its end."""
    from powerserve_tpu_torch.ops.flash_decode import (decode_visibility,
                                                       pack_intra)
    from powerserve_tpu_torch.speculative.device_tree import TreeTemplate

    g = torch.Generator(device=dev)
    g.manual_seed(Tq + t0)
    S, T = 3, 2048
    first = ([t0 + 40, t0 + 1500, t0 - 300] if t0
             else [40, 1500, 2100])
    if tree:
        first[0] = t0 - 3 if t0 else T - 3
    committed = first[:2] + [first[2] if t0 else 0]
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _slice_state(dev, g, S, Hkv, T, D)
    pos = (torch.tensor(first, device=dev)[:, None]
           + torch.arange(Tq, device=dev)[None, :]).to(torch.int32)
    mask = (t0 + torch.arange(T, device=dev)[None, :]
            < torch.tensor(committed, device=dev)[:, None])
    bits = None
    if tree:
        anc = (torch.from_numpy(TreeTemplate.from_widths([2, 1, 1]).anc)
               if Tq == 7 else torch.ones(Tq, Tq, dtype=torch.bool).tril())
        bits = pack_intra(anc.to(dev))
    args = (q, kq, ks, vq, vs, mask, pos, 1.0 / D ** 0.5)
    name = "flash_decode_state_tree" if tree else "flash_decode_state"
    before = cuda_lib.launch_counts()[name]
    got = flash_decode_cuda(*args, bits=bits, state=True, t0=t0)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()[name] == before + 1
    ref = flash_decode_quant_reference(*args, bits=bits, state=True, t0=t0)
    vis = decode_visibility(mask, pos.long() - t0, Tq, bits)
    seen = vis.any(dim=-1)[:, None, :].expand(S, H, Tq).reshape(S, H * Tq)
    assert not seen[2].any() and seen[1].all()
    if tree and t0:  # slot 0: some rows see the slice, the root's not
        assert seen[0].any() and not seen[0].all()
    _held_state(got, ref, seen, vs)
    again = flash_decode_cuda(*args, bits=bits, state=True, t0=t0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("starts,committed,t0", [
    ([2008, 3000, 500], [2008, 3000, 500], 2048),
    ([0, 1990, 2100], [0, 1990, 0], 0),
])
def test_flash_prefill_state_kernel(dev, starts, committed, t0):
    """The prefill state mode at llama-8b's heads over a 2,048-position
    slice from t0: a 128-row chunk that starts before the slice (its
    first rows see none of it), one inside it, one wholly on the other
    rank."""
    g = torch.Generator(device=dev)
    g.manual_seed(t0 + 7)
    S, Tq, H, Hkv, D, T = 3, 128, 32, 8, 128, 2048
    q = torch.randn(S, Tq, H, D, generator=g, device=dev)
    kq, ks, vq, vs = _slice_state(dev, g, S, Hkv, T, D)
    mask = (t0 + torch.arange(T, device=dev)[None, :]
            < torch.tensor(committed, device=dev)[:, None])
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    args = (q, kq, ks, vq, vs, mask, start, 1.0 / D ** 0.5)
    before = cuda_lib.launch_counts()["flash_prefill_state"]
    got = flash_prefill_cuda(*args, state=True, t0=t0)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_prefill_state"] == before + 1
    ref = flash_prefill_quant_reference(*args, state=True, t0=t0)
    # row i of slot s sees the slice where the mask does or where its
    # interval [start, start + i] meets [t0, t0 + T)
    rows = torch.arange(Tq, device=dev)[None, :]
    st = start.long()[:, None]
    sees = (((st + rows >= t0) & (st < t0 + T))
            | mask.any(dim=1)[:, None])
    seen = sees[:, None, :].expand(S, H, Tq).reshape(S, H * Tq)
    assert (~seen).any() and seen.any()
    _held_state(got, ref, seen, vs)
    again = flash_prefill_cuda(*args, state=True, t0=t0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
