#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (powerserve_tpu_torch) on one NVIDIA GPU.

Phases, each printing one JSON line:
  build      compile csrc/*.cu with nvcc (one process per source), with
             the card's name and power limit
  kernels    each kernel and its plain PyTorch twin on the card at the
             llama-8b main-path shapes: max error against its tolerance,
             CUDA-event times (warm, L2 flushed, median of 25), the bound
             at 3.35 TB/s or 989 TFLOP/s bf16
  cli        the `run` entry (greedy, -n 16) on synthetic tiny Q8_0 and
             tiny-k Q4_K workspaces, on cuda and on the cpu plain path;
             tokens must agree (a divergence only where the cpu top-2
             logit gap is < 0.5) and every kernel's launch count must
             rise; the logits of the prompt and of each generated token
             fed back one at a time must agree between cuda and cpu
  full_width llama-8b Q4_K (32 layers, random weights built on the card):
             prefill_step over 512 tokens; one decode step on the
             kernels against the same step through the plain twins on
             the card; decode_scan for 64 tokens (argmax head);
             InferenceEngine.generate for the same 64 tokens (logits
             head). The two token streams must agree. The launch counts
             are zeroed just before each of the three paths and read just
             after it, and each path must have launched its kernels.
Then the kernels line (launch counts from the generate run), the
card's nvidia-smi line and, last, {"ok": true, "device": ...}.

Any failure raises and exits non-zero; so does a machine without CUDA.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
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
        flash_decode_cuda, flash_decode_quant_reference)
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
    torch.cuda.synchronize()
    emit({"phase": "kernels", "qmatmul": qmm_rows, "fused_head": head_rows,
          "flash_decode": fd_rows})

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
            if not all(counts.values()):
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


def phase_full_width(dev: torch.device) -> tuple[dict, dict]:
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
    from powerserve_tpu_torch.ops.fused import fused_linear_reference
    from powerserve_tpu_torch.ops.qmatmul import qmatmul_reference
    from powerserve_tpu_torch.tools.bench_params import make_device_params

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model = make_device_params("llama-8b", "q4_k", seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
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
    # 512 query rows attend through the plain prefill attention
    logits, prefill_s = counted("prefill_step", ("qmatmul", "fused_head"),
                                lambda: prefill_step(
                                    model, prompt[None].to(dev),
                                    torch.arange(n_prompt, device=dev)[None],
                                    kv))
    if logits.shape != (1, llm.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite or misshapen")
    first = logits.argmax(dim=-1)

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
    gen_ids, _ = counted("generate", all3, lambda: list(engine.generate(
        prompt.tolist() + [int(first)], n_decode, stats=stats)))
    if scan_ids != gen_ids:
        raise AssertionError(f"decode_scan (argmax head) {scan_ids} != "
                             f"generate (logits head) {gen_ids}")
    return ({"phase": "full_width", "preset": "llama-8b", "quant": "q4_k",
             "layers": llm.n_layers, "vocab": llm.vocab_size,
             "params_build_s": build_s,
             "prefill_tokens": n_prompt,
             "prefill_tok_s": n_prompt / prefill_s,
             "decode_step_logit_gap": step_gap,
             "decode_tokens": n_decode, "decode_tok_s": n_decode / decode_s,
             "generate_prefill_tok_s": stats.prefill_speed,
             "generate_decode_tok_s": stats.decode_speed,
             "tokens_equal": True, "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "card": card_line()}, launches["generate"])


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
    full, counts = phase_full_width(dev)
    emit(full)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
