"""Tracing and perf counters: the port of the JAX package's core/trace.py
over torch.profiler.

  - Trace: start_tracing / stop_tracing around a torch.profiler session
    (CPU activity, plus CUDA activity when a card is present), written
    as a Chrome-trace JSON that Perfetto opens; span(name) is a
    record_function range, cheap whether or not tracing is on. The span
    names and their call sites are the JAX package's: prefill chunks and
    decode blocks (engine/generator.py), the host tree engine's draft
    forward and verify (speculative/engine.py). Spans sit around a
    replayed CUDA graph, never inside a captured step body, where they
    would be recorded only at capture.
  - PerfSnapshot / log_perf: CPU times, IO bytes and RSS/VMS from /proc,
    logged at stages.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass

import torch

from .logging import get_logger

log = get_logger("trace")


class Trace:
    """torch.profiler-backed span tracing (one session a process)."""

    _prof = None
    _dir: str | None = None

    @classmethod
    def start_tracing(cls, trace_dir: str | None = None) -> None:
        """Start a profiler session whose trace stop_tracing writes into
        trace_dir (default: powerserve_trace under the temporary dir)."""
        from torch.profiler import ProfilerActivity, profile

        if cls._prof is not None:
            return
        trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                              "powerserve_trace")
        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        cls._prof = profile(activities=acts)
        cls._prof.start()
        cls._dir = trace_dir
        log.info(f"tracing -> {trace_dir}")

    @classmethod
    def stop_tracing(cls) -> str | None:
        """Stop the session and write its Chrome-trace JSON; its path, or
        None when no session was on."""
        if cls._prof is None:
            return None
        prof, cls._prof = cls._prof, None
        prof.stop()
        path = os.path.join(cls._dir, f"trace_{os.getpid()}_"
                                      f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log.info(f"trace written to {path}")
        return path

    @staticmethod
    @contextlib.contextmanager
    def span(name: str):
        """Named span (usable whether or not tracing is active)."""
        with torch.profiler.record_function(name):
            yield

    # the JAX package's span names (its reference's token_tree.cpp:145,
    # qnn_backend.cpp:91-103)
    SPAN_DRAFT_FORWARD = "draft_decode"
    SPAN_TARGET_FORWARD = "target_forward"
    SPAN_VERIFY = "tree_verify"
    SPAN_PREFILL = "prefill"
    SPAN_DECODE = "decode_step"
    SPAN_LOGITS = "copy_logits"


@dataclass
class PerfSnapshot:
    """One /proc sample."""

    utime_s: float = 0.0
    stime_s: float = 0.0
    read_bytes: int = 0
    write_bytes: int = 0
    vms_mb: float = 0.0
    rss_mb: float = 0.0
    wall_s: float = 0.0

    @classmethod
    def capture(cls) -> "PerfSnapshot":
        snap = cls(wall_s=time.time())
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().split()
            tick = os.sysconf("SC_CLK_TCK")
            snap.utime_s = int(parts[13]) / tick
            snap.stime_s = int(parts[14]) / tick
            page = os.sysconf("SC_PAGE_SIZE")
            snap.vms_mb = int(parts[22]) / 1e6
            snap.rss_mb = int(parts[23]) * page / 1e6
        except OSError:
            pass
        try:
            with open("/proc/self/io") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    if k == "read_bytes":
                        snap.read_bytes = int(v)
                    elif k == "write_bytes":
                        snap.write_bytes = int(v)
        except OSError:
            pass
        return snap

    def delta(self, since: "PerfSnapshot") -> str:
        return (f"cpu {self.utime_s - since.utime_s:.2f}u/"
                f"{self.stime_s - since.stime_s:.2f}s "
                f"io {(self.read_bytes - since.read_bytes) / 1e6:.1f}MB r/"
                f"{(self.write_bytes - since.write_bytes) / 1e6:.1f}MB w "
                f"rss {self.rss_mb:.0f}MB "
                f"wall {self.wall_s - since.wall_s:.2f}s")


def log_perf(stage: str, since: PerfSnapshot | None = None) -> PerfSnapshot:
    """Log a perf snapshot at a stage; returns it."""
    now = PerfSnapshot.capture()
    if since is not None:
        log.info(f"[perf] {stage}: {now.delta(since)}")
    else:
        log.info(f"[perf] {stage}: rss {now.rss_mb:.0f}MB")
    return now
