#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (powerserve_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  build      compile csrc/*.cu with nvcc (one process per source), with
             the card's name and power limit
  kernels    each kernel and its plain PyTorch twin on the card at the
             llama-8b main-path shapes: max error against its tolerance,
             CUDA-event times (warm, L2 flushed, median of 25), the bound
             at 3.35 TB/s or 989 TFLOP/s bf16 (attention: over the
             positions this run's inputs make visible); flash-prefill at
             run's shape, the scheduler's bucket and a ragged T, paged
             flash-decode with pages of 64 and 8
  cli        the `run` entry (greedy, -n 16) on synthetic tiny Q8_0 and
             tiny-k Q4_K workspaces, on cuda and on the cpu plain path;
             tokens must agree (a divergence only where the cpu top-2
             logit gap is < 0.5) and every kernel's launch count must
             rise; the logits of the prompt and of each generated token
             fed back one at a time must agree between cuda and cpu
  serve      the HTTP server on the same two workspaces, on cuda and cpu,
             with the dense cache and with a paged pool that preempts:
             four concurrent greedy completions and a streamed and a
             plain chat completion; cuda agrees with cpu, paged with
             dense, every request with a lone generate (near-tie rule),
             SSE deltas with the plain reply; the path's kernels launch;
             no request ends in "error" and the scheduler logs no error
  params     llama-8b Q4_K random weights built on the card
  full_width llama-8b (32 layers): prefill_step over 512 tokens on the
             kernels, and against the same prefill with flash-prefill
             sent to its twin; one decode step on the kernels against
             the same step through the plain twins on the card;
             decode_scan for 64 tokens (argmax head);
             InferenceEngine.generate for the same 64 tokens (logits
             head). The two token streams must agree. The launch counts
             are zeroed just before each of the three paths and read just
             after it, and each path must have launched its kernels.
  serve_full_width  llama-8b behind the HTTP server: 8 slots over a paged
             pool of half of 8 x 2048 positions, 8 concurrent greedy
             requests (prompts of 128-1024 tokens, 64 new tokens): all
             finish "length", two agree with a lone generate, the paged
             and prefill kernels launch; generated tok/s, TTFT, peak pages
             and memory
Then the kernels line (launch counts from the generate run for the run
path's kernels, from serve_full_width for flash-prefill and paged
flash-decode), the card's nvidia-smi line and, last,
{"ok": true, "device": ...}.

Any failure raises and exits non-zero; so does a machine without CUDA.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import http.client
import json
import logging
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
NEAR_TIE = 0.5  # the reference's greedy near-tie gap
# logits of a whole forward on the kernels against the plain path, as a
# share of the plain logits' range: each kernel agrees with its twin to
# f32 rounding, but the bf16 roundings of the residual stream and of
# every matmul input may then fall the other way (2^-8 of one element
# each) and carry through the layers
LOGIT_REL = 1e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


class Timer:
    """CUDA-event time of one call, warm, with the L2 cache flushed and
    the GPU kept busy while the host enqueues the call."""

    def __init__(self, dev: torch.device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int = 25) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(50_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_kernels(dev: torch.device) -> list[dict]:
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_cuda, flash_decode_paged_cuda,
        flash_decode_paged_reference, flash_decode_quant_reference,
        gather_pages)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_cuda, flash_prefill_quant_reference, prefill_visibility)
    from powerserve_tpu_torch.ops.fused import (fused_head_cuda,
                                                fused_linear_reference,
                                                norm_rounding_slack)
    from powerserve_tpu_torch.ops.qmatmul import (qmatmul_cuda,
                                                  qmatmul_reference)
    from powerserve_tpu_torch.tools.bench_params import _rand_qlinear

    timer = Timer(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def check(name, got, ref, rel_tol, slack=0.0):
        err = (got.float() - ref.float()).abs()
        tol = rel_tol * max(1.0, ref.float().abs().max().item()) + slack
        if not (err <= tol).all():
            raise AssertionError(f"{name}: max abs err {err.max().item()}, "
                                 f"{(err - tol).max().item()} over tolerance")
        return err.max().item()

    def flips_check(name, got, ref, vs, rel_tol=1e-4):
        """Attention over the int8 cache: kernel and twin sum the f32
        scores in another order, so p * vs, rounded to bf16 before the
        value product, may round the other way next to a midpoint. Each
        such flip moves a whole head row by one bf16 ulp of that term,
        and all of them together by at most 2^-8 * 127 * max vs. At most
        1 in 100 outputs may exceed rel_tol, none by more than that."""
        err = (got.float() - ref.float()).abs()
        tol = rel_tol * max(1.0, ref.float().abs().max().item())
        flip = 2.0 ** -8 * 127 * vs.float().abs().max().item()
        over = (err > tol).float().mean().item()
        if over > 1e-2 or not (err <= tol + flip).all():
            raise AssertionError(f"{name}: max abs err {err.max().item()}, "
                                 f"{over} of outputs over {tol}")
        return err.max().item()

    def cache(S, Hkv, T, D):
        """Random int8 K/V [S, Hkv, T, D] and f32 scales [S, Hkv, T]."""
        kq, vq = (torch.randint(-127, 128, (S, Hkv, T, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
                  for _ in range(2))
        return kq, ks, vq, vs

    # -- qmatmul: Q4_K (bf16 scales + mins, packed) at the four 8B
    #    projection shapes, decode and prefill M; Q4_0 and Q8_0 at one
    #    shape each. Tolerance: f32 sums in another order.
    qmm_rows = []
    cases = [("q4_k", m, k, n) for m in (1, 512)
             for k, n in ((4096, 6144), (4096, 4096), (4096, 28672),
                          (14336, 4096))]
    cases += [("q4_0", 1, 4096, 4096), ("q8_0", 1, 4096, 4096)]
    for quant, m, k, n in cases:
        lin = _rand_qlinear(g, k, n, quant, dev)
        x = randn(m, k, dtype=torch.bfloat16)
        ref = qmatmul_reference(x, lin)
        err = check(f"qmatmul {quant} {m}x{k}x{n}", qmatmul_cuda(x, lin),
                    ref, 1e-4)
        ms = timer(lambda: qmatmul_cuda(x, lin))
        plain = timer(lambda: qmatmul_reference(x, lin), reps=20)
        b, by = bound_ms(nbytes(x) + lin.nbytes() + m * n * 4,
                         2.0 * m * n * k)
        qmm_rows.append(dict(quant=quant, m=m, k=k, n=n, max_abs_err=err,
                             ms=ms, plain_ms=plain, bound_ms=b, bound_by=by))
        del lin, x, ref
    # a loader-style weight: f32 scales, unpacked int8
    lin = _rand_qlinear(g, 4096, 4096, "q8_0", dev)
    lin.scales = lin.scales.float()
    x = randn(1, 4096, dtype=torch.bfloat16)
    check("qmatmul q8_0 f32 scales", qmatmul_cuda(x, lin),
          qmatmul_reference(x, lin), 1e-4)

    # -- fused head: llama-8b lm_head, Q4_K, vocab 128256, M = 1 and 4
    head = _rand_qlinear(g, 4096, 128256, "q4_k", dev)
    nw = torch.rand(4096, generator=g, device=dev) + 0.5
    head_rows = []
    for m in (1, 4):
        h = randn(m, 4096, dtype=torch.bfloat16) * 3
        ref = fused_linear_reference(head, h, nw)
        # tolerance: f32 sums in another order, plus the logits that an
        # element of the bf16-rounded normalized rows next to a rounding
        # midpoint moves if the f32 norm's last bits differ
        logits = fused_head_cuda(head, h, nw)
        err = check(f"fused head logits M={m}", logits, ref, 1e-4,
                    norm_rounding_slack(head, h, nw))
        tok = fused_head_cuda(head, h, nw, argmax=True)
        if not torch.equal(tok, logits.argmax(dim=-1).to(torch.int32)):
            raise AssertionError(f"fused head argmax {tok.tolist()} is not "
                                 f"the first maximum of its logits")
        wbytes = nbytes(h, nw) + head.nbytes()
        for argmax in (False, True):
            ms = timer(lambda: fused_head_cuda(head, h, nw, argmax=argmax))
            plain = timer(lambda: fused_linear_reference(head, h, nw, argmax),
                          reps=20)
            out_b = m * 4 if argmax else m * 128256 * 4
            b, by = bound_ms(wbytes + out_b, 2.0 * m * 128256 * 4096)
            head_rows.append(dict(m=m, argmax=argmax, max_abs_err=err, ms=ms,
                                  plain_ms=plain, bound_ms=b, bound_by=by))
    del head

    # -- flash decode: llama-8b heads, S = 1, T = 1024 all visible; and a
    #    ragged T with partial, fully masked and Tq = 2 rows (correctness)
    fd_rows = []
    scale = 1.0 / 128 ** 0.5
    for S, Tq, T, ragged in ((1, 1, 1024, False), (2, 2, 1000, True)):
        H, Hkv, D = 32, 8, 128
        q = randn(S, Tq, H, D)
        kq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                           dtype=torch.int8)
        vq = torch.randint(-127, 128, (S, Hkv, T, D), generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
        vs = torch.rand(S, Hkv, T, generator=g, device=dev) * 0.02
        vis = torch.ones(S, Tq, T, dtype=torch.bool, device=dev)
        if ragged:
            vis[0, 0, 700:] = False
            vis[1, 1] = False  # a row that sees nothing
        args = (q, kq, ks, vq, vs, vis, scale)
        ref = flash_decode_quant_reference(*args)
        err = check(f"flash_decode S={S} Tq={Tq} T={T}",
                    flash_decode_cuda(*args), ref, 1e-4)
        ms = timer(lambda: flash_decode_cuda(*args))
        plain = timer(lambda: flash_decode_quant_reference(*args), reps=20)
        # informational: SDPA over bf16 K/V dequantized outside the timing
        qh = q.permute(0, 2, 1, 3).to(torch.bfloat16)
        kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(H // Hkv, dim=1)
                  for c, sc in ((kq, ks), (vq, vs)))
        sdpa = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=vis[:, None]))
        b, by = bound_ms(nbytes(q, kq, vq, ks, vs, vis) + S * Tq * H * D * 4,
                         4.0 * S * Tq * H * T * D)
        fd_rows.append(dict(S=S, Tq=Tq, T=T, max_abs_err=err, ms=ms,
                            plain_ms=plain, bound_ms=b, bound_by=by,
                            sdpa_bf16_dequantized_ms=sdpa))
    def sdpa_ms(q, kq, ks, vq, vs, vis):
        """Informational: SDPA over bf16 K/V dequantized outside the
        timing, one call (not used by the port)."""
        H, Hkv = q.shape[2], kq.shape[1]
        qh = q.permute(0, 2, 1, 3).to(torch.bfloat16)
        kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(H // Hkv, dim=1)
                  for c, sc in ((kq, ks), (vq, vs)))
        return timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=vis[:, None]))

    def attn_bound(q, vis, Hkv, extra_bytes):
        """Least time for attention over the visible positions only: q
        and out once, each K/V row (2 * D int8 + 2 f32 scales) of a
        position some row sees once, 4 * D operations per (row, head,
        visible position)."""
        S, Tq, H, D = q.shape
        cols = int(vis.any(dim=1).sum())
        return bound_ms(2 * nbytes(q) + cols * Hkv * (2 * D + 8)
                        + extra_bytes, 4.0 * D * H * float(vis.sum()))

    # -- flash prefill: run's shape (S = 1, Tq = 512, start 0), the
    #    scheduler's bucket (S = 8, Tq = 128, varied starts, -1 included, a
    #    committed prefix, decoding slots' committed positions) and a ragged
    #    T with D = 64 (correctness; tolerance: 1e-4 plus rare bf16 flips of
    #    p * vs, see flips_check)
    fp_rows = []
    H, Hkv, D, T = 32, 8, 128, 2048
    fp_cases = [
        ("run", 1, 512, T, 128, [0], [0]),
        ("bucket", 8, 128, T, 128, [0, 128, -1, 512, 40, 1000, -1, 1900],
         [0, 128, 300, 512, 40, 1000, 0, 1900]),
        ("ragged", 3, 100, 1000, 64, [0, 37, -1], [0, 37, 600]),
    ]
    for name, S, Tq, Tc, Dc, starts, committed in fp_cases:
        Hc, Hkvc = (32, 8) if Dc == 128 else (14, 2)
        q = randn(S, Tq, Hc, Dc)
        kq, ks, vq, vs = cache(S, Hkvc, Tc, Dc)
        mask = (torch.arange(Tc, device=dev)[None, :]
                < torch.tensor(committed, device=dev)[:, None])
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        args = (q, kq, ks, vq, vs, mask, start, 1.0 / Dc ** 0.5)
        ref = flash_prefill_quant_reference(*args)
        err = flips_check(f"flash_prefill {name}", flash_prefill_cuda(*args),
                          ref, vs)
        row = dict(case=name, S=S, Tq=Tq, T=Tc, D=Dc, starts=starts,
                   committed=committed, max_abs_err=err)
        if name != "ragged":
            vis = prefill_visibility(mask, start, Tq)[..., :Tc]
            b, by = attn_bound(q, vis, Hkvc, nbytes(mask, start))
            row.update(
                ms=timer(lambda: flash_prefill_cuda(*args)),
                plain_ms=timer(lambda: flash_prefill_quant_reference(*args),
                               reps=5),
                bound_ms=b, bound_by=by,
                visible_positions=int(vis.sum()),
                sdpa_bf16_dequantized_ms=sdpa_ms(q, kq, ks, vq, vs, vis))
        fp_rows.append(row)
        del q, kq, vq, ref

    # -- paged flash decode: S = 8, Tq = 1, ~600 filled positions per slot
    #    of 2048, pages scrambled through the pool with unallocated
    #    entries; pages of 64 (timed) and of 8 (correctness)
    fdp_rows = []
    for page in (64, 8):
        S, Tq, MP = 8, 1, T // page
        filled = [560 + 13 * s for s in range(S)]
        n_alloc = [-(-(f + 1) // page) for f in filled]
        P = sum(n_alloc) + 8
        perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
        pt = torch.full((S, MP), P, dtype=torch.int32, device=dev)
        used = 0
        for s_, n in enumerate(n_alloc):
            pt[s_, :n] = perm[used:used + n]
            used += n
        q = randn(S, Tq, H, D)
        kp, ksp, vp, vsp = cache(P, Hkv, page, D)
        vis = (torch.arange(T, device=dev)[None, None, :]
               < torch.tensor(filled, device=dev)[:, None, None]
               ).expand(S, Tq, T).contiguous()
        args = (q, kp, ksp, vp, vsp, pt, vis, scale)
        ref = flash_decode_paged_reference(*args)
        err = flips_check(f"flash_decode_paged page={page}",
                          flash_decode_paged_cuda(*args), ref, vsp)
        row = dict(page=page, S=S, Tq=Tq, T=T, filled=filled,
                   max_abs_err=err)
        if page == 64:
            b, by = attn_bound(q, vis, Hkv, nbytes(vis, pt))
            row.update(
                ms=timer(lambda: flash_decode_paged_cuda(*args)),
                plain_ms=timer(lambda: flash_decode_paged_reference(*args),
                               reps=20),
                bound_ms=b, bound_by=by,
                sdpa_bf16_dequantized_ms=sdpa_ms(
                    q, *(gather_pages(t, pt) for t in (kp, ksp, vp, vsp)),
                    vis))
        fdp_rows.append(row)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "qmatmul": qmm_rows, "fused_head": head_rows,
          "flash_decode": fd_rows, "flash_prefill": fp_rows,
          "flash_decode_paged": fdp_rows})

    def entry(name, route_src, replaces, row):
        return dict(name=name, route="cuda", source=route_src,
                    replaces=replaces, launches=0,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None)

    qmm_head = next(r for r in qmm_rows if r["quant"] == "q4_k"
                    and r["m"] == 1 and r["n"] == 28672)
    return [
        entry("qmatmul", "powerserve_tpu_torch/csrc/qmatmul.cu",
              "powerserve_tpu/ops/qmatmul.py:565", qmm_head),
        entry("fused_head", "powerserve_tpu_torch/csrc/fused_head.cu",
              "powerserve_tpu/ops/fused.py:298",
              next(r for r in head_rows if r["m"] == 1 and not r["argmax"])),
        entry("flash_decode", "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:115", fd_rows[0]),
        entry("flash_prefill", "powerserve_tpu_torch/csrc/flash_prefill.cu",
              "powerserve_tpu/ops/flash_prefill.py:115", fp_rows[1]),
        entry("flash_decode_paged",
              "powerserve_tpu_torch/csrc/flash_decode.cu",
              "powerserve_tpu/ops/flash_decode.py:183", fdp_rows[0]),
    ]


def first_divergence(a: list[int], b: list[int]) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| as a share of ref's range."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / (ref.max() - ref.min())).item()


def phase_cli() -> dict:
    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.core.config import WorkspaceConfig
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    result = {"phase": "cli", "logit_tolerance": LOGIT_REL}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, quant in (("tiny", GGMLType.Q8_0),
                              ("tiny-k", GGMLType.Q4_K)):
            ws = make_synthetic_gguf(f"{tmp}/{preset}", preset, quant, seed=0,
                                     seq_len=256)
            argv = ["-d", str(ws), "-p", "The quick brown fox", "-n", "16",
                    "--temperature", "0", "--no-progress"]
            cuda_lib.reset_launch_counts()
            gpu = run.run_prompt(run.parse_args(argv + ["--device", "cuda"]))
            counts = cuda_lib.launch_counts()
            if not all(counts[k] for k in ("qmatmul", "fused_head",
                                           "flash_decode", "flash_prefill")):
                raise AssertionError(f"{preset}: a kernel was not launched: "
                                     f"{counts}")
            cpu = run.run_prompt(run.parse_args(argv + ["--device", "cpu"]))
            hp = WorkspaceConfig.load(ws).hyper_params
            eng_gpu, _ = run.build_engine(str(ws / "model"), hp, "cuda")
            eng_cpu, _ = run.build_engine(str(ws / "model"), hp, "cpu")
            # the prompt's last logits, then each generated token fed back
            # alone (a decode step), on the kernels and on the plain path
            gaps = [logit_gap(eng_gpu.prefill(part), eng_cpu.prefill(part))
                    for part in [gpu.prompt_ids] + [[t] for t in gpu.ids]]
            if not max(gaps) <= LOGIT_REL:
                raise AssertionError(f"{preset}: cuda and cpu logits differ "
                                     f"by {max(gaps)} of their range")
            i = first_divergence(gpu.ids, cpu.ids)
            gap = None
            if i >= 0:
                # the cpu logits for the step that chose token i, teacher-
                # forced on the gpu's tokens
                eng_cpu.reset()
                logits = eng_cpu.prefill(gpu.prompt_ids + gpu.ids[:i])
                top2 = logits.topk(2).values
                gap = float(top2[0] - top2[1])
                if not gap < NEAR_TIE:
                    raise AssertionError(
                        f"{preset}: cuda {gpu.ids} vs cpu {cpu.ids} differ "
                        f"at {i} with a top-2 gap of {gap}")
            result[preset] = dict(tokens_cuda=gpu.ids, tokens_cpu=cpu.ids,
                                  first_divergence=i, top2_gap=gap,
                                  logit_gap_max=max(gaps),
                                  logit_gap_steps=len(gaps),
                                  launches=counts)
    return result


def phase_full_width(dev: torch.device, cfg, model) -> tuple[dict, dict]:
    from unittest import mock

    import powerserve_tpu_torch.models.llama as llama
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import (GenerationStats,
                                                       InferenceEngine)
    from powerserve_tpu_torch.engine.loops import decode_scan, prefill_step
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_quant_reference)
    from powerserve_tpu_torch.ops.flash_prefill import (
        flash_prefill_quant_reference)
    from powerserve_tpu_torch.ops.fused import fused_linear_reference
    from powerserve_tpu_torch.ops.qmatmul import qmatmul_reference

    torch.cuda.reset_peak_memory_stats(dev)
    llm = cfg.llm
    n_prompt, n_decode, max_seq = 512, 64, 2048
    g = torch.Generator(device="cpu")
    g.manual_seed(1)
    prompt = torch.randint(3, llm.vocab_size, (n_prompt,), generator=g)
    launches: dict[str, dict] = {}

    def counted(path: str, need: tuple, fn):
        """Run one path with the launch counts zeroed just before it and
        read just after it; every kernel in `need` must have launched."""
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[path] = cuda_lib.launch_counts()
        missing = [k for k in need if not launches[path][k]]
        if missing:
            raise AssertionError(f"{path} did not launch {missing}: "
                                 f"{launches[path]}")
        return out, seconds

    all3 = ("qmatmul", "fused_head", "flash_decode")
    kv = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                        llm.head_size, dev)
    # 512 query rows attend through the flash-prefill kernel
    logits, prefill_s = counted("prefill_step",
                                ("qmatmul", "fused_head", "flash_prefill"),
                                lambda: prefill_step(
                                    model, prompt[None].to(dev),
                                    torch.arange(n_prompt, device=dev)[None],
                                    kv))
    if logits.shape != (1, llm.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or misshapen")
    first = logits.argmax(dim=-1)

    # the same 512-token prefill with flash_prefill_quant sent to its twin
    # on the card, into a fresh cache
    kv_twin = KVCache.create(llm.n_layers, 1, max_seq, llm.n_kv_heads,
                             llm.head_size, dev)
    cuda_lib.reset_launch_counts()
    with mock.patch.object(llama, "flash_prefill_quant",
                           flash_prefill_quant_reference):
        logits_twin = prefill_step(model, prompt[None].to(dev),
                                   torch.arange(n_prompt, device=dev)[None],
                                   kv_twin)
    if cuda_lib.launch_counts()["flash_prefill"]:
        raise AssertionError("the twin prefill launched the kernel")
    prefill_gap = logit_gap(logits, logits_twin)
    top2 = logits_twin[0].topk(2)
    if not prefill_gap <= LOGIT_REL or (
            first[0] != top2.indices[0]
            and not float(top2.values[0] - top2.values[1]) < NEAR_TIE):
        raise AssertionError(f"prefill on the flash-prefill kernel differs "
                             f"from its twin by {prefill_gap} of the range")
    del kv_twin, logits_twin

    # one decode step on the kernels, and the same step with the forward's
    # three kernel calls sent to their plain twins, on copies of the cache
    def step(routes: dict) -> torch.Tensor:
        c = KVCache(*(t.clone() for t in (kv.k, kv.v, kv.k_scale,
                                           kv.v_scale, kv.mask, kv.pos)))
        with (mock.patch.multiple(llama, **routes) if routes
              else contextlib.nullcontext()):
            return model(c, first[:, None], kv.pos.long()[:, None],
                         logits_mode="last")[0]

    def plain_fused(lin, *, norm, argmax=False, eps=1e-5):
        return fused_linear_reference(lin, norm[0], norm[1], argmax, eps)

    def plain_qmm(x, lin):
        y = qmatmul_reference(x.reshape(-1, x.shape[-1]), lin)
        return y.reshape(*x.shape[:-1], lin.out_features)

    step_kernels = step({})
    step_plain = step(dict(qmatmul=plain_qmm, fused_linear=plain_fused,
                           flash_decode_quant=flash_decode_quant_reference))
    step_gap = logit_gap(step_kernels, step_plain)
    if not torch.isfinite(step_kernels).all() or not step_gap <= LOGIT_REL:
        raise AssertionError(f"decode step on the kernels differs from the "
                             f"plain twins by {step_gap} of the range")
    top2 = step_plain.topk(2)
    if (step_kernels.argmax() != top2.indices[0]
            and not float(top2.values[0] - top2.values[1]) < NEAR_TIE):
        raise AssertionError("decode step: the kernels' greedy token is not "
                             "the plain path's")
    del step_kernels, step_plain

    toks, decode_s = counted("decode_scan", all3,
                             lambda: decode_scan(model, first, kv, n_decode))
    scan_ids = toks[0].tolist()
    if not all(0 <= t < llm.vocab_size for t in scan_ids):
        raise AssertionError(f"decode_scan tokens out of range: {scan_ids}")
    del kv

    hp = HyperParams(max_slots=1, max_seq_len=max_seq, batch_size=n_prompt)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, hp, device=dev)
    stats = GenerationStats()
    gen_ids, _ = counted("generate", all3 + ("flash_prefill",),
                         lambda: list(engine.generate(
                             prompt.tolist() + [int(first)], n_decode,
                             stats=stats)))
    if scan_ids != gen_ids:
        raise AssertionError(f"decode_scan (argmax head) {scan_ids} != "
                             f"generate (logits head) {gen_ids}")
    return ({"phase": "full_width", "preset": "llama-8b", "quant": "q4_k",
             "layers": llm.n_layers, "vocab": llm.vocab_size,
             "prefill_tokens": n_prompt,
             "prefill_tok_s": n_prompt / prefill_s,
             "prefill_logit_gap": prefill_gap,
             "decode_step_logit_gap": step_gap,
             "decode_tokens": n_decode, "decode_tok_s": n_decode / decode_s,
             "generate_prefill_tok_s": stats.prefill_speed,
             "generate_decode_tok_s": stats.decode_speed,
             "tokens_equal": True, "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "card": card_line()}, launches["generate"])


# -- the serving path -------------------------------------------------------


class ServeRecorder:
    """While active: every request submitted to a BatchScheduler keeps its
    prompt ids (as submitted) and the ids its sink received, and every
    error the scheduler logs (a failed step ends its requests with
    "error") is kept, so a kernel failure cannot pass as a short answer."""

    def __init__(self):
        self.requests: list[tuple[list[int], list[int], object]] = []
        self.errors: list[str] = []
        self._lock = threading.Lock()

    def __enter__(self):
        from unittest import mock

        from powerserve_tpu_torch.engine.scheduler import BatchScheduler

        original = BatchScheduler.submit
        rec = self

        def submit(sched, req):
            ids: list[int] = []
            inner = req.sink

            def sink(t):
                if t is not None:
                    ids.append(t)
                inner(t)

            req.sink = sink
            with rec._lock:
                rec.requests.append((list(req.prompt_ids), ids, req))
            return original(sched, req)

        class Errors(logging.Handler):
            def emit(self, record):
                rec.errors.append(record.getMessage())

        self._handler = Errors(level=logging.ERROR)
        self._log = logging.getLogger("powerserve_tpu_torch.scheduler")
        self._log.addHandler(self._handler)
        self._patch = mock.patch.object(BatchScheduler, "submit", submit)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        self._log.removeHandler(self._handler)
        return False

    def check(self, label: str) -> None:
        bad = [r.id for _, _, r in self.requests
               if r.finish_reason == "error"]
        if bad or self.errors:
            raise AssertionError(f"{label}: requests {bad} ended in error; "
                                 f"scheduler errors: {self.errors}")

    def tokens(self) -> dict[tuple, list[int]]:
        return {tuple(p): ids for p, ids, _ in self.requests}


def http_call(port: int, method: str, path: str, body: dict | None = None,
              timeout: float = 900) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def sse_text(data: bytes, chat: bool) -> tuple[str, str]:
    """(concatenated deltas, finish reason) of an SSE stream."""
    text, finish = "", None
    for line in data.decode().splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        ch = json.loads(line[6:])["choices"][0]
        text += (ch.get("delta", {}).get("content", "") if chat
                 else ch.get("text", ""))
        finish = ch.get("finish_reason") or finish
    return text, finish


def metrics_of(port: int) -> dict[str, float]:
    status, data = http_call(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {}
    for line in data.decode().splitlines():
        if line:
            key, val = line.rsplit(" ", 1)
            out[key.split("{")[0].removeprefix("powerserve_")] = float(val)
    return out


def concurrently(calls: list) -> list:
    """Run the zero-argument calls in threads at once; their results."""
    out = [None] * len(calls)
    errs = []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed or hung: {errs}")
    return out


def serving(ctx):
    """An HTTP server for ctx on an ephemeral port, in a thread."""
    from powerserve_tpu_torch.serving.server import make_server

    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def agree(label: str, got: list[int], want: list[int], engine,
          prompt: list[int]) -> float | None:
    """got equals want, or first differs where the reference engine's
    teacher-forced top-2 logit gap is < NEAR_TIE; returns that gap."""
    i = first_divergence(got, want)
    if i < 0:
        return None
    engine.reset()
    top2 = engine.prefill(prompt + want[:i]).float().topk(2).values
    gap = float(top2[0] - top2[1])
    if not gap < NEAR_TIE:
        raise AssertionError(f"{label}: {got} vs {want} differ at {i} with "
                             f"a top-2 gap of {gap}")
    return gap


SERVE_PROMPTS = ["ab", "cde", "xy z", "hello"]
SERVE_CHAT = [{"role": "user", "content": "hi"}]


def serve_run(ws, hp, device: str) -> dict:
    """Serve the workspace on `device` over HTTP: four concurrent greedy
    completions, a streamed and a plain chat completion, all at once."""
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext

    ctx = ServerContext(ws, "model", hp, device)
    server = serving(ctx)
    port = server.server_address[1]
    try:
        calls = [lambda p=p: http_call(port, "POST", "/v1/completions", {
            "model": "model", "prompt": p, "max_tokens": 12,
            "temperature": 0}) for p in SERVE_PROMPTS]
        calls += [lambda st=st: http_call(port, "POST", "/v1/chat/completions",
                                          {"model": "model",
                                           "messages": SERVE_CHAT,
                                           "max_tokens": 16,
                                           "temperature": 0, "stream": st})
                  for st in (True, False)]
        with ServeRecorder() as rec:
            cuda_lib.reset_launch_counts()
            replies = concurrently(calls)
            if device == "cuda":
                torch.cuda.synchronize()
            launches = cuda_lib.launch_counts()
        rec.check(f"serve {device}")
        for status, data in replies:
            if status != 200:
                raise AssertionError(f"serve {device}: {status} {data[:200]}")
        texts = [json.loads(d)["choices"][0]["text"] for _, d in replies[:4]]
        streamed, finish = sse_text(replies[4][1], chat=True)
        plain = json.loads(replies[5][1])["choices"][0]
        if streamed != plain["message"]["content"] or \
                finish != plain["finish_reason"]:
            raise AssertionError(f"serve {device}: SSE deltas {streamed!r} "
                                 f"({finish}) != {plain!r}")
        return dict(tokens=rec.tokens(), texts=texts, chat_text=streamed,
                    launches=launches, metrics=metrics_of(port))
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()


def phase_serve(devices=("cuda", "cpu")) -> dict:
    """The port's HTTP server on tiny Q8_0 and tiny-k Q4_K workspaces, on
    each device, with the dense cache and with a paged pool small enough
    to preempt (10 pages of 8 tokens: the chat template alone is 55
    tokens, 4 completions and 2 chats need ~30 pages at once)."""
    from powerserve_tpu_torch.core.config import HyperParams, WorkspaceConfig
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    need = {"dense": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode"),
            "paged": ("qmatmul", "fused_head", "flash_prefill",
                      "flash_decode_paged")}
    result: dict = {"phase": "serve"}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, quant in (("tiny", GGMLType.Q8_0),
                              ("tiny-k", GGMLType.Q4_K)):
            ws = make_synthetic_gguf(f"{tmp}/{preset}", preset, quant, seed=0,
                                     seq_len=256)
            engines = {}
            for device in devices:
                cfg, model = load_gguf_model(ws / "model", device=device)
                hp = HyperParams(max_slots=1, batch_size=128, max_seq_len=256)
                hp.sampler.temperature = 0.0
                tok = Tokenizer.from_model_dir(ws / "model")
                engines[device] = (InferenceEngine(model, cfg, hp,
                                                   eos_id=tok.eos_id,
                                                   device=device), tok)
            runs, out = {}, {}
            for cache, pages in (("dense", 0), ("paged", 10)):
                for device in devices:
                    hp = WorkspaceConfig.load(ws).hyper_params
                    hp.max_slots, hp.paged_pages, hp.page_size = 4, pages, 8
                    run = runs[cache, device] = serve_run(ws, hp, device)
                    label = f"{preset} {cache} {device}"
                    if device == "cuda":
                        missing = [k for k in need[cache]
                                   if not run["launches"][k]]
                        if missing:
                            raise AssertionError(f"{label}: did not launch "
                                                 f"{missing}")
                    if cache == "paged" and not \
                            run["metrics"]["paged_preemptions_total"] > 0:
                        raise AssertionError(f"{label}: no preemption")
                    # each request against a lone generate on its device
                    engine, tok = engines[device]
                    gaps = []
                    for prompt, ids in run["tokens"].items():
                        engine.reset()
                        want = list(engine.generate(
                            list(prompt), len(ids), stop_fn=tok.should_stop))
                        gaps.append(agree(f"{label} vs generate", ids, want,
                                          engine, list(prompt)))
                    out[f"{cache}_{device}"] = dict(
                        texts=run["texts"], chat=run["chat_text"],
                        launches=run["launches"],
                        preemptions=run["metrics"].get(
                            "paged_preemptions_total"),
                        vs_generate_near_ties=[x for x in gaps
                                               if x is not None])
                # the paged pool gives the dense cache's tokens, and cuda
                # the cpu's
                ref_dev = devices[-1]
                for prompt, ids in runs[cache, devices[0]]["tokens"].items():
                    for other in devices[1:]:
                        agree(f"{preset} {cache} {devices[0]} vs {other}",
                              ids, runs[cache, other]["tokens"][prompt],
                              engines[other][0], list(prompt))
                    if cache == "paged":
                        agree(f"{preset} paged vs dense", ids,
                              runs["dense", devices[0]]["tokens"][prompt],
                              engines[ref_dev][0], list(prompt))
            result[preset] = out
    return result


def phase_serve_full_width(dev: torch.device, cfg, model) -> tuple[dict, dict]:
    """llama-8b Q4_K (random weights) behind the HTTP server: 8 slots over
    a paged pool of 128 pages of 64 tokens (half of 8 x 2048, yet enough
    for all eight at once), 8 concurrent greedy requests with prompts of
    128-1024 tokens and 64 new tokens each."""
    import random

    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.serving.server import ServerContext
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tokenizer.vocab import GGUFVocab
    from powerserve_tpu_torch.tools.synthetic import _simple_vocab

    toks, scores, types = _simple_vocab(cfg.llm.vocab_size)
    tok = Tokenizer(vocab=GGUFVocab.from_metadata({
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
        "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0}),
        bos_id=1, eos_id=2, stop_ids={2}, add_bos=True)
    n_new, lengths = 64, [128, 256, 384, 512, 640, 768, 896, 1024]
    rng = random.Random(0)
    # one byte token per letter, after the BOS and the 3-byte space prefix
    texts = ["".join(rng.choice("abcdefghijklmnopqrsuvwxyz")
                     for _ in range(n - 4)) for n in lengths]
    hp = HyperParams(max_slots=8, max_seq_len=2048, batch_size=128,
                     paged_pages=128, page_size=64)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = ServerContext(tmp, "llama-8b", hp, dev)
        mctx = ctx.register("llama-8b", model, cfg, tok)
        server = serving(ctx)
        port = server.server_address[1]
        try:
            pool = mctx.scheduler.pool
            calls = [lambda t=t: http_call(port, "POST", "/v1/completions", {
                "model": "llama-8b", "prompt": t, "max_tokens": n_new,
                "temperature": 0}) for t in texts]
            peak_used = [0]
            done = threading.Event()

            def watch():
                while not done.is_set():
                    peak_used[0] = max(peak_used[0],
                                       pool.n_pages - pool.n_free)
                    time.sleep(0.02)

            watcher = threading.Thread(target=watch, daemon=True)
            with ServeRecorder() as rec:
                cuda_lib.reset_launch_counts()
                watcher.start()
                t0 = time.perf_counter()
                replies = concurrently(calls)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                done.set()
                launches = cuda_lib.launch_counts()
            watcher.join(timeout=5)
            rec.check("serve_full_width")
            finish = []
            for status, data in replies:
                if status != 200:
                    raise AssertionError(f"serve_full_width: {status} "
                                         f"{data[:200]}")
                finish.append(json.loads(data)["choices"][0]["finish_reason"])
            tokens = rec.tokens()
            n_tokens = [len(ids) for ids in tokens.values()]
            if finish != ["length"] * 8 or n_tokens != [n_new] * 8:
                raise AssertionError(f"serve_full_width: finish {finish}, "
                                     f"tokens {n_tokens}")
            missing = [k for k in ("qmatmul", "fused_head", "flash_prefill",
                                   "flash_decode_paged") if not launches[k]]
            if missing:
                raise AssertionError(f"serve_full_width did not launch "
                                     f"{missing}: {launches}")
            metrics = metrics_of(port)
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        finally:
            server.shutdown()
            server.server_close()
            ctx.close()
    # the shortest and the longest request against a lone generate
    ehp = HyperParams(max_slots=1, max_seq_len=2048, batch_size=128)
    ehp.sampler.temperature = 0.0
    engine = InferenceEngine(model, cfg, ehp, eos_id=2, device=dev)
    gaps = []
    by_len = sorted(tokens.items(), key=lambda kv_: len(kv_[0]))
    for prompt, ids in (by_len[0], by_len[-1]):
        engine.reset()
        want = list(engine.generate(list(prompt), n_new,
                                    stop_fn=tok.should_stop))
        gaps.append(agree("serve_full_width vs generate", ids, want, engine,
                          list(prompt)))
    del engine
    return ({"phase": "serve_full_width", "preset": "llama-8b",
             "quant": "q4_k", "slots": 8, "pool_pages": 128, "page": 64,
             "prompt_tokens": sorted(len(p) for p in tokens),
             "new_tokens": n_new, "wall_s": wall,
             "generated_tok_s": 8 * n_new / wall,
             "ttft_p50_s": metrics["ttft_seconds_p50"],
             "ttft_p90_s": metrics["ttft_seconds_p90"],
             "latency_p50_s": metrics["request_latency_seconds_p50"],
             "pages_used_peak": peak_used[0],
             "preemptions": metrics["paged_preemptions_total"],
             "vs_generate_near_ties": [g for g in gaps if g is not None],
             "launches": launches, "peak_mem_gb": peak_gb,
             "card": card_line()}, launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import powerserve_tpu_torch  # noqa: F401 — fails outside the repo
    from powerserve_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    cuda_lib.lib()
    ptxas = [ln.strip() for ln in cuda_lib.BUILD_INFO.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": cuda_lib.BUILD_INFO.get("dir"), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})
    kernels = phase_kernels(dev)
    emit(phase_cli())
    emit(phase_serve())
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    t0 = time.perf_counter()
    cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "params", "preset": "llama-8b", "quant": "q4_k",
          "build_s": time.perf_counter() - t0})
    full, counts = phase_full_width(dev, cfg, model)
    emit(full)
    serve, serve_counts = phase_serve_full_width(dev, cfg, model)
    emit(serve)
    # launches from the run of each kernel's own path: the run path's
    # generate for the first slice's kernels, the server for this one's
    for k in kernels:
        k["launches"] = (serve_counts if k["name"] in (
            "flash_prefill", "flash_decode_paged") else counts)[k["name"]]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
