"""Time the batch routes of the MoE expert FFN on the GPU.

A decode batch of a few rows runs its expert FFN through the grouped
dispatch at block_m 16 (ops/moe.py and the grouped kernel: three
launches per layer). The JAX package runs some such batches through
every expert's slab on the dense kernel instead, each row weighted by
its routing weight or 0 (its dense route: three launches per expert per
layer), which the port leaves out for the times this tool measures
(models/llama.py keeps the grouped route only). This tool builds a preset's
random Q4_K parameters (tools/bench_params.py) and prints, for each batch
of S rows and each route, one JSON line:
  ffn_device_ms  one layer's expert FFN alone on the device: CUDA events,
                 the GPU kept busy while the host enqueues, median of 20
  ffn_wall_ms    the same FFN called back to back: wall time per call,
                 host enqueue or device time, whichever is longer
  step_wall_ms   a whole decode step of S slots (Tq = 1) over a 64-token
                 context: wall time per step over 10 back-to-back steps
  launches       quantized-matmul launches of one FFN
then the card's name and power limit.

    python -m powerserve_tpu_torch.tools.moe_routes [--preset mixtral-lite]
        [--rows 2 8 16 32]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from unittest import mock

import torch

from ..kv.cache import KVCache
from ..models import llama
from ..ops import cuda_lib
from ..ops.qmatmul import GEMV_MAX_M, qmatmul
from .bench_params import make_device_params


def dense_all_experts(layer: llama.LlamaLayer, h: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The dense route: every expert's FFN over all rows of h, each row's
    output weighted by its routing weight for that expert, or 0."""
    topi, topw = layer.route(h, k)
    out = torch.zeros(h.shape[0], h.shape[-1], dtype=torch.float32,
                      device=h.device)
    for e in range(layer.w_gate_exps.n_slabs):
        y = layer._experts(h, lambda a, w: qmatmul(a, w.slab(e)))
        out = out + y * torch.where(topi == e, topw, 0.0).sum(dim=-1)[:, None]
    return out


def routed(route: str):
    """A context in which every MoE FFN of more than one row takes
    `route`: "grouped" (block_m 16) or "dense"."""
    if route == "grouped":
        return mock.patch.object(
            llama, "moe_route",
            lambda rows: ("single", 1) if rows == 1 else ("grouped",
                                                          GEMV_MAX_M))
    return mock.patch.object(llama.LlamaLayer, "moe_ffn", dense_all_experts)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of fn: the host enqueues it behind a sleep kernel
    longer than the enqueue, so the events bracket device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-4) * 4e9)  # >= 2x the host time at 2 GHz
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="moe_routes")
    ap.add_argument("--preset", default="mixtral-lite")
    ap.add_argument("--rows", type=int, nargs="+", default=[2, 8, 16, 32])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("moe_routes measures a GPU; none is present")
    dev = torch.device("cuda")
    cfg, model = make_device_params(args.preset, "q4_k", device=dev)
    llm = cfg.llm
    k, ctx = llm.n_experts_used, 64
    g = torch.Generator().manual_seed(0)
    for S in args.rows:
        h = torch.randn(S, llm.dim, generator=g).to(dev, torch.bfloat16)
        kv = KVCache.create(llm.n_layers, S, 2 * ctx, llm.n_kv_heads,
                            llm.head_size, dev)
        toks = torch.randint(3, llm.vocab_size, (S, ctx + 1), generator=g)
        pos = torch.arange(ctx).expand(S, ctx).contiguous()
        model(kv, toks[:, :ctx].to(dev), pos.to(dev), logits_mode="none")
        nxt = toks[:, ctx:].to(dev)
        step_pos = torch.full((S, 1), ctx, dtype=torch.long, device=dev)
        for route in ("grouped", "dense"):
            with routed(route):
                layer = model.layers[0]

                def ffn():
                    return layer.moe_ffn(h, k)

                cuda_lib.reset_launch_counts()
                ffn()
                counts = cuda_lib.launch_counts()
                row = dict(
                    preset=args.preset, rows=S, experts=llm.n_experts,
                    top_k=k, route=route,
                    ffn_device_ms=device_ms(ffn),
                    ffn_wall_ms=wall_ms(ffn, 20),
                    step_wall_ms=wall_ms(lambda: model(
                        kv, nxt, step_pos, logits_mode="last"), 10),
                    launches=counts["qmatmul"] + counts["qmatmul_grouped"])
            print(json.dumps(row), flush=True)
        del kv
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
