"""Where a decode step's time goes on the GPU.

Builds random llama-8b Q4_K parameters (tools/bench_params.py) with a
2048-token cache, prefills a prompt, then traces greedy decode steps
(engine/loops.py::decode_scan, each step a replayed CUDA graph, warmed
and captured first) with torch.profiler and prints one JSON line: the
wall time per step, the GPU kernel time per step (summed over the
trace's device events), the device busy share, and the kernels with the
most device time.

    python -m powerserve_tpu_torch.tools.profile_decode [--prompt 512]
        [--steps 8]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..engine.loops import decode_scan, prefill_step
from ..kv.cache import KVCache
from .bench_params import make_device_params

PRESET, QUANT, MAX_SEQ = "llama-8b", "q4_k", 2048


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="profile_decode")
    ap.add_argument("--prompt", type=int, default=512,
                    help="context length the decode steps start from")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode measures a GPU; none is present")
    cfg, model = make_device_params(PRESET, QUANT, device=dev)
    llm = cfg.llm
    kv = KVCache.create(llm.n_layers, 1, MAX_SEQ, llm.n_kv_heads,
                        llm.head_size, dev)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(3, llm.vocab_size, (1, args.prompt), generator=g)
    logits = prefill_step(model, prompt.to(dev),
                          torch.arange(args.prompt, device=dev)[None], kv)
    tok = logits.argmax(dim=-1)
    # warm: the first step eager, the second captured, at the step
    # capacity the timed calls use
    tok = decode_scan(model, tok, kv, args.steps)[:, -1]
    torch.cuda.synchronize()
    # wall time without the profiler, then the device time under it
    t0 = time.perf_counter()
    tok = decode_scan(model, tok, kv, args.steps)[:, -1]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode_scan(model, tok, kv, args.steps)
        torch.cuda.synchronize()
    gpu = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels: dict[str, float] = {}
    for ev in gpu:
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    device_us = sum(kernels.values()) / args.steps
    top = sorted(kernels.items(), key=lambda kv_: -kv_[1])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "preset": PRESET, "quant": QUANT,
        "context": args.prompt, "steps": args.steps,
        "wall_ms_per_step": wall * 1e3,
        "device_kernel_ms_per_step": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / (wall * 1e3),
        "gpu_events_per_step": len(gpu) / args.steps,
        "top_kernels_us_per_step": {k: v / args.steps for k, v in top},
        "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
