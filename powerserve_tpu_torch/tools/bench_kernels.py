"""Quantized-matmul microbenchmarks (the JAX package's
tools/bench_kernels.py): the same six qmatmul cases (format, K, N, M) on
the port's kernels, one JSON line each with the microseconds a call and
the packed weight's GB/s.

On the card, each case is timed with CUDA events around `--iters`
launches after a warm-up (the card runs them back to back; nothing is
hoisted, so no chained state is needed). A sleep kernel ahead of the
start event holds the card while the host enqueues them, so the events
time the kernels, not the host's launch rate. The launches cycle through
copies of the weight that together hold three times the H100's 50 MB L2
cache, so each launch reads its weight from device memory, as a decode
step does. With --device cpu the plain PyTorch twin runs, timed by the
host clock: useful only to test the command.

  python -m powerserve_tpu_torch bench-kernels [--iters 1024]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.gguf import GGMLType
from ..ops.qmatmul import QLinear, qmatmul

L2_BYTES = 50 << 20  # the H100's L2 cache
# the sleep ahead of the timed launches: 100 us a launch at ~2 GHz, more
# than the host takes to enqueue one
SLEEP_CYCLES_PER_CALL = 200_000

CASES = [
    (GGMLType.Q4_K, 4096, 14336, 1),
    (GGMLType.Q4_0, 4096, 14336, 1),
    (GGMLType.Q8_0, 4096, 14336, 1),
    (GGMLType.Q4_K, 4096, 14336, 16),
    (GGMLType.Q4_K, 4096, 6144, 1),
    (GGMLType.Q4_K, 14336, 4096, 1),
]


def time_us(fn, iters: int, dev: torch.device) -> float:
    """Microseconds a call of fn, over iters calls after one warm-up."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * SLEEP_CYCLES_PER_CALL)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters * 1e3


def bench_qmatmul(fmt: int, K: int, N: int, M: int, iters: int,
                  device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    lin = QLinear.from_float(w, fmt, device=dev)
    x = torch.as_tensor(rng.standard_normal((M, K)), dtype=torch.bfloat16,
                        device=dev)
    copies = (-(-3 * L2_BYTES // lin.nbytes()) if dev.type == "cuda"
              else 1)
    lins = [lin] + [copy.deepcopy(lin) for _ in range(copies - 1)]
    turn = itertools.count()
    us = time_us(lambda: qmatmul(x, lins[next(turn) % copies]), iters, dev)
    return {"fmt": GGMLType(fmt).name, "K": K, "N": N, "M": M,
            "us_per_call": round(us, 1),
            "GBps": round(lin.nbytes() / (us * 1e-6) / 1e9, 1)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch bench-kernels")
    ap.add_argument("--iters", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (the plain twin)")
    args = ap.parse_args(argv)
    for fmt, K, N, M in CASES:
        print(json.dumps(bench_qmatmul(fmt, K, N, M, args.iters,
                                       args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
