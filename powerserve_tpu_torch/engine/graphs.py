"""Fixed-shape decode steps replayed as CUDA graphs.

The JAX package compiles each decode loop into one device program (a
jax.jit over a lax.scan: engine/loops.py's decode_scan, the engine's
decode block, the scheduler's tick, the chain step). The port captures
one step of each such loop into a torch.cuda.CUDAGraph and replays it
once per step, so a step costs one graph launch of host time, not the
~80 eager ops and launches per layer of a Python forward.

A StepGraph holds a body: a function of no arguments that reads static
device buffers (the step's tokens, `active`, the sampler's settings, a
step counter), runs fixed-shape forwards that change the cache in place,
and writes static outputs. On `cuda`:
  - the first call runs the body eagerly. That is real work on the real
    cache, and it also builds the kernel library, fills the cached
    device properties and runs the kernels' one-time attribute setup.
    There is no extra warm-up run: every forward writes the KV cache and
    advances pos, so another run would change the state;
  - the second call captures the body, then replays it;
  - every later call replays it.
On the CPU, where the wrappers run their plain twins, the body runs
eagerly and no graph is built, as it does on any device for the steps
of a StepGraphs(eager=True) (a rank group's scheduler: its steps hold
collectives). StepGraph.eager runs the body eagerly on any device: the
replayed paths' twin. Nothing catches an error of a
capture or a replay: which steps replay is decided by the caller (greedy
or sampled), never by a failure.

The kernel wrappers count their launches in Python (ops/cuda_lib.py
LAUNCHES), and that Python runs while a graph is captured, not when it
is replayed. The counts a capture adds are taken back out (nothing ran)
and every replay adds them, so a replayed path reports the counts of the
eager path over the same steps. (A launch another thread counts during a
capture is taken for the capture's: the counters are diagnostics, shared
by all threads.)

A graph bakes in the addresses of the cache, the weights and the
buffers, so it belongs to one owner, a StepGraphs: an engine's or a
scheduler's own, or one a cache carries for the free functions
(graphs_of), keyed by the cache and freed with it. Each owner has its
own memory pool and capture stream: scheduler threads of different
models replay at the same time, and graphs that share a pool share their
temporaries. Captures are serialized process-wide, since PyTorch runs
one at a time, in "thread_local" mode, so other threads may go on (load
a model, run a tick) while a scheduler thread captures. Python's cyclic
garbage collector is held off during a capture: a collection run by an
allocation inside the body could destroy a graph no longer reachable
(an owner left in a reference cycle), and destroying a graph is an
operation not permitted while the thread captures, which invalidates the
capture. Such a graph goes at the next collection after the capture.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Callable

import torch

from ..ops import cuda_lib

_capture_lock = threading.Lock()


@contextlib.contextmanager
def _collection_held_off():
    """No automatic cyclic garbage collection inside (a capture)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """One fixed-shape step: `body` eagerly on the first call, captured
    on the second and replayed from then on (on `cuda`; always eager on
    the CPU). `bufs` holds the static buffers the body reads and writes;
    a call returns the body's outputs, valid until the next call."""

    def __init__(self, body: Callable[[], object], bufs: dict,
                 device: torch.device, pool, stream, deps: tuple,
                 eager: bool = False):
        self.body = body
        self.eager_only = eager
        self.bufs = bufs
        self.device = device
        self.pool, self.stream = pool, stream
        self.deps = deps  # weak references to what the graph reads
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.counts: dict[str, int] = {}
        self.replays = 0  # calls that replayed the graph
        self.warm = False
        self.capture_s = 0.0

    def __call__(self):
        if self.device.type != "cuda" or self.eager_only:
            return self.body()
        if self.graph is None:
            if not self.warm:
                self.warm = True
                return self.body()
            self._capture()
        self.graph.replay()
        self.replays += 1
        for name, n in self.counts.items():
            cuda_lib.LAUNCHES[name] += n
        return self.out

    def eager(self):
        """The body, run eagerly: the replayed path's twin."""
        return self.body()

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, _collection_held_off():
            before = cuda_lib.launch_counts()
            t0 = time.perf_counter()
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                out = self.body()
            self.capture_s = time.perf_counter() - t0
            # the capture launched nothing: its counts come back with
            # every replay
            for name, n in cuda_lib.launch_counts().items():
                if n != before[name]:
                    self.counts[name] = n - before[name]
                    cuda_lib.LAUNCHES[name] -= self.counts[name]
        self.graph, self.out = graph, out


class StepGraphs:
    """The step graphs of one owner on one device, with the memory pool
    and the capture stream they share. Bodies hold no reference to the
    owner, so the graphs go with it."""

    def __init__(self, device: torch.device, eager: bool = False):
        """eager: every step runs its body eagerly (a step that holds a
        collective of a rank group cannot be captured)."""
        self.device = torch.device(device)
        self.eager = eager
        self.graphs: dict[tuple, StepGraph] = {}
        self.pool = self.stream = None
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def step(self, key: tuple,
             build: Callable[[], tuple[Callable[[], object], dict]],
             deps: tuple = ()) -> StepGraph:
        """The step graph for `key` (what the body's shapes and constants
        depend on), built by build() -> (body, bufs) at first use. `deps`
        are the objects whose memory the body reads besides the owner's
        (models, a second cache): held weakly, and an entry whose deps are
        gone or replaced is built anew."""
        full = key + tuple(id(d) for d in deps)
        g = self.graphs.get(full)
        if g is None or any(r() is not d for r, d in zip(g.deps, deps)):
            body, bufs = build()
            g = self.graphs[full] = StepGraph(
                body, bufs, self.device, self.pool, self.stream,
                tuple(weakref.ref(d) for d in deps), self.eager)
        return g


_on_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def graphs_of(kv) -> StepGraphs:
    """The step graphs of the free functions over the cache `kv` (a new
    cache, kv.clone() too, has none), freed with it. Their bodies must
    reach kv through a weak reference."""
    g = _on_cache.get(kv)
    if g is None:
        g = _on_cache[kv] = StepGraphs(kv.device)
    return g


def steps_capacity(n_steps: int) -> int:
    """The step rows of a graph's output buffers for a call of n_steps:
    the next power of two, so callers with nearby n share one graph."""
    return 1 << max(int(n_steps) - 1, 0).bit_length()


def pool_bytes(graphs: StepGraphs) -> int:
    """Bytes the card holds in the memory pool of `graphs` (0 on the
    CPU)."""
    if graphs.pool is None:
        return 0
    pool = tuple(graphs.pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)
