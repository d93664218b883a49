"""Continuous-batching scheduler: requests -> slots of one batched model.

Every decode tick advances ALL decoding slots in one forward per step
(`decode_horizon` steps per tick); prefill runs chunk-wise over every
prefilling slot at once, with priority over decode but never starving it
(`decode_every`); each request carries its own sampling parameters and
random generator. The cache is the dense int8 KVCache or, with
hp.paged_pages > 0, the paged pool, where admission defers while the
pool is dry and decode preempts the youngest request by recompute.

With a draft model (a separate model, or a view of the target's first
layers: speculative/chain.py self_draft_model) every decode tick runs
`hp.spec_horizon` steps of batched speculation instead, over a dense
int8 draft cache beside the dense or paged target cache. The topology is
hp.spec_tree's widths (speculative/device_tree.py TreeTemplate), or a
chain of hp.spec_k. A chain runs chain_spec_sample_scan's step: each
slot drafts with its own sampler settings and stream, one target forward
verifies all slots, speculative sampling accepts per slot (temperature 0
is greedy). A tree runs tree_sample_step: one draft forward per level,
one verify of every slot's tree with the ancestor mask, and exact-match
acceptance against the target's samples, or with hp.spec_wor
draws without replacement and recursive rejection. Prefill fills both
caches, prefix-cache entries carry both prefixes, and a preempted
request rebuilds both. Speculative ticks apply no penalties and record
no logprobs (the server refuses such requests).

A plain decode tick replays one CUDA graph per step (engine/graphs.py)
over the scheduler's static [S] buffers (tokens, `active`, each slot's
sampler settings and penalties) and writes each step's tokens and
logprobs into static [S, horizon] outputs through a step counter. The
graph holds the whole step: forward, sampler chain, the argmax (an
all-greedy tick) or each slot's draw from its stream (csrc/sample.cu
reads and advances the counters on the device), the penalty push and
the logprobs. A spec tick replays one graph per speculative step the
same way, greedy or sampled (its draws come between the draft
forwards, inside the graph). So there are two graphs per tick shape,
greedy and sampled. The prefill tick stays eager.

Decode ticks are double-buffered, as the JAX scheduler's: tick N + 1 is
dispatched before tick N's results are processed. Each tick's outputs
(and kv.pos) leave the card in one asynchronous copy into pinned memory
right after its replays, in stream order, before the next tick's first
replay overwrites the static buffers; the drain waits on that copy's
event only. Request identities are captured at dispatch, and the results
of a slot reused since are void. A slot still owned by its request takes
its next input token from the device (the last tick's token buffer,
through a carry mask), not from the host's cur_token, which the drain
has not set yet; a slot that finished in tick N has run tick N + 1 too,
whose penalty push the next admission resets and whose draws the next
request's first decode resets (its counter to 0). The host's
inputs of a tick go to the card in one copy from pinned memory, so
dispatch waits for nothing. On the paged pool a tick is fast (double-
buffered) when every decoding slot's drained position is known and the
pool grants two ticks ahead of it (_pos_drained, _pos_known: JAX's
rule, with its two spare pages when the pool has slack); otherwise it
drains, grants exactly, runs single-buffered and counts in
paged_slow_ticks. Spec ticks are double-buffered on the dense cache and
single-buffered on the pool (their acceptance decides the positions).
Jobs (call), stop() and a failed step drain or drop the tick in flight
first.

With an EAGLE head (speculative/eagle.py) the draft is the head: its
dense int8 cache sits beside the target's, and each slot carries the
target feature f32 [dim] paired with its next token. A prefill chunk
runs the target with its final hidden states, then the head over the
same tokens, lane i paired with the feature of lane i - 1 (lane 0 with
the carried one); the carry becomes the feature at each slot's last
real lane. Prefix-cache entries keep the feature too (an entry without
one is no hit), and a preempted slot rebuilds it with both caches. Its
ticks run eagle_sample_step (a chain of spec_k) or
eagle_tree_sample_step (hp.spec_tree), replayed as the draft model's.

A request may carry its prompt's input rows (Request.embeds: the text
embeddings with image features at the image-context positions,
models/internvl.py), a row per prompt token at the model's dim. A
prefill chunk then takes each such slot's rows in place of the embedding
lookup (the choice per slot from host-side flags), through the target, a
draft model of the same dim (its own lookup for the other slots) or an
EAGLE target; embed requests skip the prefix cache (image-context ids
are all alike), a preempted one extends its rows with its generated
tokens' embeddings, and a trimmed prompt trims its rows too.

Over a rank group (parallel/tp.py), the model, the draft (a TPModel or
an EAGLE head's TPEagleHead) and the caches are rank 0's handles: every
forward and cache operation is
broadcast to the follower ranks, which apply it to their shards, so the
ticks run as they are. Those ticks run eagerly (their steps hold
collectives, which no graph captures); with dp > 1 the paged pool's
page grants keep each dp block's slots in that block's pages
(PagePool(n_groups=dp)), and a starved slot preempts only a victim of
its own block. A request's input rows go to every rank with the
forward, the other slots' rows from TPModel.embed's vocab-sharded
lookup; rank 0 makes every draw, and its ticks double-buffer as one
device's (their gloo collectives wait for each forward, so nothing
overlaps). On a pp mesh (parallel/pp.py, the JAX pp_mesh branches) each
forward runs the stages in turn and the last one's logits, tokens or
final hidden come back to rank 0, so the same ticks run: plain ones on
the dense cache and the pool, multimodal prefills, a draft model's chain
(its layers staged too) and EAGLE's chain and tree, the head and its
cache whole on every stage; a draft model's tree is refused, as JAX's
scheduler refuses it. On an sp mesh the dense cache's positions split
over the sp ranks, and every tick runs: plain ones, multimodal prefills,
MoE models, a draft model's chain and tree (a draft level's attn_mask
is cut to each rank's slice, and the commit moves an accepted entry to
the rank whose slice holds its destination), and EAGLE's chain and tree
with the head's cache whole on every sp rank; the pool is refused, as
JAX refuses paged KV under sequence parallelism. The host
keeps a mirror of every slot's cache position (pos_host): admission,
prefill and each plain tick's dispatch (every active slot advances by
the horizon) keep it exact, and a single-buffered spec tick's fetch
refreshes it, so the paged pool grants pages without reading the card.
Only the scheduler thread touches the device; submit() is thread-safe,
and call(fn) runs fn on the scheduler thread between two steps (device
work for a request, such as encoding its images, never lands inside a
step's graph capture).

HTTP sessions pin prefix-cache entries (the server's /v1/sessions):
pin_prefix marks a prefix whose snapshot the prefill that completes it
pins (a pinned entry skips the min-length rule and is never evicted for
capacity), insert_prefix stores an entry from a session file's host
arrays, export_prefix gives one back as host arrays and drop_prefix
removes one; the three run on the scheduler thread (call), where the
copies to and from the device happen. Over a rank group an entry's
snapshots are handles on every rank's heads: export gathers them in the
global head order, insert gives each rank its heads in every dp block.
release() stops the scheduler and drops what it holds on the device (a
server's eviction).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.config import HyperParams, ModelConfig
from ..core.device import resolve_device
from ..core.logging import get_logger
from ..kv.cache import KVCache
from ..kv.paged import PagedKVCache, PagePool
from ..models.llama import LlamaModel
from ..parallel.tp import TPEagleHead, TPModel
from ..sampling.sampler import (DrawState, PenaltyState,
                                categorical_from_dist, sample_dist_batched)
from ..speculative.chain import sample_step
from ..speculative.device_tree import TreeTemplate, tree_sample_body
from ..speculative.eagle import EagleHead, eagle_forward, eagle_sample_body
from .graphs import StepGraphs

log = get_logger("scheduler")

N_TOP = 8  # top-logprob alternatives recorded per step


@dataclass
class Request:
    prompt_ids: list[int]
    max_tokens: int = 128
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    penalty_repeat: float = 1.0
    # subtractive OpenAI-style penalties over the recent-token window
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    stop_ids: set[int] = field(default_factory=set)
    # explicit per-request seed (OpenAI `seed`): the slot's stream is
    # seeded with it, so the samples reproduce whatever else runs
    seed: int | None = None
    # top-logprob alternatives to record per token (0 = off)
    logprobs: int = 0
    # the prompt's input rows [len(prompt_ids), dim] on the scheduler's
    # device (a VLM prompt: image features at the image-context
    # positions; the width is the model's dim). The prompt must
    # END with a text token (the decode feeds it through the embedding
    # table). Such requests skip the prefix cache: the image-context ids
    # are all alike, so token-id keys would match across images.
    embeds: torch.Tensor | None = None
    # receives token ids, then None when finished
    sink: Callable[[int | None], None] = lambda t: None
    id: int = 0
    # set by the consumer to abort (e.g. a stop string matched in the
    # decoded text); the scheduler frees the slot on its next tick
    cancelled: bool = False
    # filled by the scheduler
    n_generated: int = 0
    finish_reason: str = ""
    token_logprobs: list = field(default_factory=list)  # [float]
    top_logprobs: list = field(default_factory=list)  # [[(id, lp)]]
    submitted_at: float = 0.0


@dataclass
class _Slot:
    req: Request | None = None
    prefill_off: int = 0
    cur_token: int = 0
    prefilling: bool = False
    # the request's Philox seed: its stream starts when decoding does
    seed: int = 0
    # tokens generated while resident: the recompute payload if the
    # paged pool preempts the slot (emitted tokens are never re-emitted)
    generated: list = field(default_factory=list)


class PrefixCache:
    """LRU of prompt-prefix KV snapshots. Requests that share a prefix
    (system prompts, few-shot headers) skip its prefill: the KV of
    positions 0..n-1 depends only on tokens 0..n-1, so reuse is exact.

    Pinned entries (HTTP sessions) skip the min-length rule and are never
    evicted for capacity; nothing caps their number. Only the scheduler
    thread changes the entries (BatchScheduler's pin, insert and drop)."""

    def __init__(self, capacity: int, min_len: int):
        self.capacity = capacity
        self.min_len = min_len
        self.entries: dict[tuple, dict] = {}
        self._order: list[tuple] = []  # eviction order; not the pinned
        self.pinned: set[tuple] = set()
        self.hits = 0
        self.misses = 0

    def match(self, prompt_ids: list[int]) -> tuple[int, dict] | None:
        """Longest cached entry that is a prefix of prompt_ids."""
        best = None
        t = tuple(prompt_ids)
        for key, saved in self.entries.items():
            n = len(key)
            if n <= len(t) and t[:n] == key and (best is None or n > best[0]):
                best = (n, saved)
        if best is None:
            self.misses += 1
        else:
            self.hits += 1
        return best

    def put(self, prefix_ids: list[int], saved: dict,
            pin: bool = False) -> None:
        """Store a snapshot (pin: pinned; an entry already there is
        pinned and kept as it is)."""
        key = tuple(prefix_ids)
        if key in self.entries:
            if pin:
                self.pinned.add(key)
                if key in self._order:
                    self._order.remove(key)
            return
        if not pin and len(key) < self.min_len:
            return
        if len(self._order) >= self.capacity and self._order:
            self.entries.pop(self._order.pop(0), None)
        self.entries[key] = saved
        if pin:
            self.pinned.add(key)
        else:
            self._order.append(key)

    def drop(self, prefix_ids: list[int]) -> bool:
        """Remove an entry, pinned or not; True if there was one."""
        key = tuple(prefix_ids)
        self.pinned.discard(key)
        if key in self._order:
            self._order.remove(key)
        return self.entries.pop(key, None) is not None

    def clear(self) -> None:
        """Remove every entry, the pinned ones too (the counters stay)."""
        self.entries.clear()
        self._order.clear()
        self.pinned.clear()


class BatchScheduler:
    """Owns the KV cache and the step loop; thread-safe submit()."""

    def __init__(self, model: LlamaModel, cfg: ModelConfig,
                 hp: HyperParams | None = None,
                 device: str | torch.device | None = None,
                 draft: LlamaModel | None = None,
                 eagle_head: EagleHead | None = None):
        """draft: batched speculation with this draft model (its vocab
        must be the target's); eagle_head: with this EAGLE head (its
        geometry is eagle_head.llm) in place of a draft model (a draft
        model takes the requests' input rows only at the target's dim)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.hp = hp or HyperParams()
        llm = cfg.llm
        if self.hp.kv_dtype != "int8":
            raise ValueError("the port keeps an int8 KV cache only")
        self.S = self.hp.max_slots
        self.max_seq = self.hp.max_seq_len or llm.seq_len
        self.chunk = max(int(self.hp.batch_size), 8)
        self.horizon = max(int(self.hp.decode_horizon), 1)
        self.pool: PagePool | None = None
        # over a rank group: the caches are shards on every rank, and the
        # ticks stay eager (their steps hold collectives)
        self.tp = isinstance(model, TPModel)
        if self.tp and not (isinstance(draft, (TPModel, type(None)))
                            and isinstance(eagle_head,
                                           (TPEagleHead, type(None)))):
            raise ValueError("a draft or EAGLE head for a rank group's "
                             "model must be sharded over the same ranks")
        if self.hp.paged_pages > 0:
            page = max(int(self.hp.page_size), 8)
            self.kv = self._new_cache(llm, n_pages=int(self.hp.paged_pages),
                                      page_size=page)
            self.max_seq = self.kv.max_seq  # rounded up to whole pages
            self.pool = PagePool(int(self.hp.paged_pages), self.S,
                                 self.kv.max_pages, page,
                                 n_groups=model.mesh.dp if self.tp else 1)
        else:
            self.kv = self._new_cache(llm)
        self.draft = self.d_kv = None
        self.spec_k = max(int(self.hp.spec_k), 1)
        self.spec_horizon = max(int(self.hp.spec_horizon), 1)
        self.spec_template = None
        if draft is not None and eagle_head is not None:
            raise ValueError("give a draft model or an EAGLE head, not both")
        self.is_eagle = eagle_head is not None
        draft = eagle_head if self.is_eagle else draft
        if draft is not None:
            # the speculation topology: hp.spec_tree's widths, or a chain
            widths = ([int(w) for w in self.hp.spec_tree.split(",")]
                      if self.hp.spec_tree else [1] * self.spec_k)
            self.spec_template = TreeTemplate.from_widths(widths)
            if draft.llm.vocab_size != llm.vocab_size:
                raise ValueError(f"draft vocab {draft.llm.vocab_size} != "
                                 f"target vocab {llm.vocab_size}")
            self._check_parallel_spec(model, any(w > 1 for w in widths))
            self.draft = draft.to(self.device)
            # an EAGLE head's cache is whole on every pp stage and sp
            # rank (the head runs replicated there; under pp as JAX's
            # does)
            self.d_kv = self._new_cache(draft.llm, staged=not self.is_eagle)
        self.penalty = PenaltyState.create(
            self.S, max(self.hp.sampler.penalty_last_n, 1), self.device)
        # one Philox stream per slot, seeded when its request starts
        # decoding
        self.draws = DrawState.create(self.S, self.device)
        # the decode steps' static buffers: the slots' settings (filled
        # by _slot_settings) and the tick's outputs, and their graphs
        S, H, dev = self.S, self.horizon, self.device
        z = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=dev)
        self.bufs = dict(
            tok=z(S, dtype=torch.int64), active=z(S, dtype=torch.bool),
            temp=z(S), top_k=z(S, dtype=torch.int64), top_p=z(S), pen=z(S),
            pfreq=z(S), ppres=z(S), step=z(1, dtype=torch.int64),
            out_tok=z(S, H, dtype=torch.int64), out_lp=z(S, H),
            out_ti=z(S, H, N_TOP, dtype=torch.int64),
            out_tlp=z(S, H, N_TOP))
        if draft is not None:
            # the spec tick's: the root is the token buffer; a tree's
            # draft levels attend with the mask as it was at its start
            Hs, W = self.spec_horizon, self.spec_template.max_depth + 1
            self.bufs.update(root=self.bufs["tok"],
                             spec_emitted=z(Hs, S, W, dtype=torch.int64),
                             spec_counts=z(Hs, S, dtype=torch.int64),
                             mask0=torch.zeros_like(self.d_kv.mask))
            if self.is_eagle:
                # each slot's carried target feature (its root's pair)
                self.bufs["feat"] = z(S, llm.dim)
        self.graphs = StepGraphs(dev, eager=self.tp)
        self.slots = [_Slot() for _ in range(self.S)]
        self.prefix_cache = None
        if self.hp.prefix_cache > 0:
            self.prefix_cache = PrefixCache(
                self.hp.prefix_cache, max(int(self.hp.prefix_cache_min), 1))
        # prefixes whose snapshot the prefill pins when it completes
        self._pin_reqs: set[tuple] = set()
        # /metrics counters
        self.n_requests = 0
        self.n_tokens_generated = 0
        self.n_prompt_tokens = 0
        self.n_preemptions = 0
        # pool ticks that fell back to the single-buffered exact path
        self.n_pool_slow_ticks = 0
        self.n_spec_steps = 0
        self.n_spec_drafted = 0
        self.n_spec_accepted = 0
        self.started_at = time.time()
        # sliding windows for latency percentiles (seconds)
        self._ttft: deque = deque(maxlen=512)
        self._req_latency: deque = deque(maxlen=512)
        # requests deferred by pool backpressure, and preempted ones:
        # admitted before anything in `pending`
        self._waitq: deque[Request] = deque()
        self.pending: queue.Queue[Request] = queue.Queue()
        self._jobs: queue.Queue[tuple[Callable, Future]] = queue.Queue()
        # call() and stop(): a job is queued before stop sets the flag
        # (and fails in its drain) or is refused
        self._jobs_lock = threading.Lock()
        # the host's mirror of kv.pos: each slot's cache position
        self.pos_host = [0] * self.S
        # the paged fast path's mirror (JAX's): each slot's drained
        # position, an upper bound, and the slots where it is known
        self._pos_drained = np.zeros(self.S, np.int64)
        self._pos_known: set[int] = set()
        # the dispatched tick whose results are not processed yet:
        # (kind, decoding, requests at dispatch, fetch handle)
        self._inflight: tuple | None = None
        self._ids = itertools.count()
        self._tick = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def _check_parallel_spec(self, model, tree: bool) -> None:
        """Refuse the speculation a pp mesh does not run, as JAX's
        scheduler refuses it: a draft model's token tree (its chain, and
        EAGLE's chain and tree, are pipelined)."""
        if self.tp and model.mesh.pp > 1 and tree and not self.is_eagle:
            raise ValueError("a draft model's token tree does not run under "
                             "pp (JAX's pp scheduler takes chains): use "
                             "--spec-k, or an EAGLE head")

    def _new_cache(self, llm, staged: bool = True, **paged) -> KVCache:
        """A dense (or, with n_pages, paged) cache of llm's geometry for
        every slot: over the model's rank group when it has one (staged:
        its layers over a pp mesh's stages)."""
        args = (llm.n_layers, self.S, self.max_seq, llm.n_kv_heads,
                llm.head_size)
        if self.tp:
            return self.model.create_cache(*args, staged=staged, **paged)
        if paged:
            return PagedKVCache.create(*args, self.device, **paged)
        return KVCache.create(*args, self.device)

    # -- front door -----------------------------------------------------------

    _RELEASED = ("the scheduler was released (its model context was "
                 "evicted)")

    def submit(self, req: Request) -> Request:
        if self.kv is None:
            raise RuntimeError(self._RELEASED)
        if req.embeds is not None:
            dim = self.cfg.llm.dim
            if tuple(req.embeds.shape) != (len(req.prompt_ids), dim):
                raise ValueError(f"Request.embeds of shape "
                                 f"{tuple(req.embeds.shape)}; the prompt "
                                 f"takes [{len(req.prompt_ids)}, {dim}]")
            if (self.draft is not None and not self.is_eagle
                    and self.draft.llm.dim != dim):
                raise ValueError(f"a draft model takes the target's input "
                                 f"rows: draft dim {self.draft.llm.dim} != "
                                 f"target dim {dim}")
        req.id = next(self._ids)
        req.submitted_at = time.time()
        self.pending.put(req)
        self._wake.set()
        return req

    def call(self, fn: Callable) -> Future:
        """Run fn() on the scheduler thread before its next step; the
        future holds its result or its exception. A stopped or released
        scheduler refuses at once: nothing would run the job."""
        fut: Future = Future()
        with self._jobs_lock:
            if self.kv is None or self._stop.is_set():
                raise RuntimeError(self._RELEASED)
            self._jobs.put((fn, fut))
        self._wake.set()
        return fut

    def _on_thread(self, fn: Callable):
        """fn() on the scheduler thread while it runs (call), else here."""
        t = self._thread
        if t is not None and t is not threading.current_thread():
            return self.call(fn).result()
        return fn()

    # -- pinned prefixes (HTTP sessions) ---------------------------------------

    def pin_prefix(self, prefix_ids: list[int]) -> None:
        """Pin the snapshot of this prefix in the prefix cache when a
        prefill of it completes (a session's priming request)."""
        if self.prefix_cache is not None:
            self._pin_reqs.add(tuple(prefix_ids))

    def insert_prefix(self, prefix_ids: list[int], groups: dict,
                      pin: bool = True) -> None:
        """Store an entry built from host arrays (a session file, kv/
        persist.py's groups: "kv", "d" with a draft, "feat" with an EAGLE
        head), copied to the device on the scheduler thread. Groups that
        do not fit this scheduler's caches raise a ValueError."""
        if self.prefix_cache is None:
            return
        if ("d" in groups) != (self.d_kv is not None) or (
                "feat" in groups) != self.is_eagle:
            raise ValueError("session draft-cache mismatch with model")

        def insert():
            saved = self.kv.snapshot_from_host(groups["kv"])
            if self.d_kv is not None:
                saved["draft"] = self.d_kv.snapshot_from_host(groups["d"])
            if self.is_eagle:
                feat = torch.as_tensor(groups["feat"]["v"])
                if tuple(feat.shape) != (self.cfg.llm.dim,):
                    raise ValueError(f"feature of shape {tuple(feat.shape)}"
                                     f"; the model's is [{self.cfg.llm.dim}]")
                saved["feat"] = feat.to(self.device, torch.float32)
            self.prefix_cache.put(list(prefix_ids), saved, pin=pin)

        self._on_thread(insert)

    def export_prefix(self, prefix_ids: list[int]) -> dict | None:
        """The entry of exactly this prefix as host arrays in groups (the
        session file's; a rank group's snapshots with every head), or
        None."""
        def export():
            saved = (self.prefix_cache.entries.get(tuple(prefix_ids))
                     if self.prefix_cache is not None else None)
            if saved is None:
                return None
            groups = {"kv": self.kv.snapshot_to_host(saved)}
            if "draft" in saved:
                groups["d"] = self.d_kv.snapshot_to_host(saved["draft"])
            if "feat" in saved:
                groups["feat"] = {"v": saved["feat"].cpu().numpy()}
            return groups

        return self._on_thread(export)

    def drop_prefix(self, prefix_ids: list[int]) -> bool:
        """Remove this prefix's entry (its device copies go with it)."""
        if self.prefix_cache is None:
            return False
        self._pin_reqs.discard(tuple(prefix_ids))
        return self._on_thread(lambda: self.prefix_cache.drop(prefix_ids))

    def clear_prefixes(self) -> None:
        """Remove every prefix-cache entry, pinned ones too."""
        if self.prefix_cache is not None:
            self._on_thread(self.prefix_cache.clear)

    def _run_jobs(self) -> None:
        if not self._jobs.empty():
            # a job may read what the tick in flight changes
            self._drain()
        while True:
            try:
                fn, fut = self._jobs.get_nowait()
            except queue.Empty:
                return
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except Exception as e:  # noqa: BLE001 — the caller reads it
                    fut.set_exception(e)

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="batch-scheduler")
            self._thread.start()

    def stop(self) -> None:
        with self._jobs_lock:
            self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._inflight is not None:
            self._drain()  # the last tick's tokens reach their requests
        while not self._jobs.empty():  # jobs that will not run now
            _, fut = self._jobs.get_nowait()
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("the scheduler stopped"))

    def release(self) -> None:
        """Stop, then drop what the scheduler holds on the device: its
        caches and page table, its step graphs and their memory pool, its
        prefix-cache snapshots and buffers, and its references to the
        models (weights another scheduler shares stay with it). The
        scheduler serves nothing after this."""
        self.stop()
        self.kv = self.d_kv = self.pool = None
        self.graphs = StepGraphs(torch.device("cpu"))
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.bufs, self.penalty, self.draws = {}, None, None
        self.model = self.draft = None

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    # -- slot bookkeeping -------------------------------------------------------

    def _emit(self, req: Request, tok: int | None) -> None:
        """Deliver to the consumer's sink (a consumer that went away must
        never kill the scheduler thread); records TTFT at the first token
        and the request latency at the end."""
        if req.submitted_at:
            if tok is None:
                self._req_latency.append(time.time() - req.submitted_at)
            elif req.n_generated == 1:
                self._ttft.append(time.time() - req.submitted_at)
        try:
            req.sink(tok)
        except Exception:  # noqa: BLE001 — the consumer's failure, not ours
            req.cancelled = True

    def _free_slot(self, i: int) -> None:
        if self.pool is not None:
            self.pool.release(i)
            self._pos_known.discard(i)
        self.slots[i] = _Slot()

    def _preempt(self, i: int) -> None:
        """Recompute preemption: free slot i's pages and re-queue its
        request with prompt = prompt + generated so far; a later prefill
        rebuilds the KV, so greedy continuations are unchanged and
        emitted tokens are never emitted again."""
        s = self.slots[i]
        req = s.req
        if req.embeds is not None and s.generated:
            # keep the rows aligned with the recompute prompt
            ext = self.model.embed.lookup(torch.tensor(
                s.generated, device=self.device)).to(req.embeds.dtype)
            req.embeds = torch.cat([req.embeds, ext])
        req.prompt_ids = list(req.prompt_ids) + s.generated
        self._waitq.appendleft(req)
        self._free_slot(i)
        self.n_preemptions += 1
        log.debug(f"req {req.id}: preempted (paged pool dry)")

    def _seed_pos(self, i: int, pos: int) -> None:
        """Paged mode: slot i's drained position for the fast path."""
        if self.pool is not None:
            self._pos_drained[i] = min(int(pos), self.max_seq)
            self._pos_known.add(i)

    def _ensure_decode_pages(self, decoding: list[int],
                             extra: int) -> list[int]:
        """Paged mode: grow each decoding slot's pages to cover the `extra`
        positions this tick may write. When the pool runs dry the YOUNGEST
        page-holding request is preempted first (least work lost); a slot
        that is itself the youngest preempts itself. A lone request the
        pool cannot serve finishes with 'length'. The positions come from
        the host mirror: no read of the card."""
        pos = self.pos_host
        for i in decoding:  # exact positions: the fast path's mirror too
            self._seed_pos(i, pos[i])
        keep = []
        for i in decoding:
            s = self.slots[i]
            if s.req is None:  # preempted as a victim earlier this tick
                continue
            while not self.pool.ensure(i, pos[i] + extra):
                # dp groups: only a victim of its own group frees pages
                # it may take
                grp = self.pool.group_of(i)
                victims = [j for j in range(self.S)
                           if j != i and self.slots[j].req is not None
                           and self.pool.owned[j]
                           and self.pool.group_of(j) == grp]
                if victims:
                    v = max(victims, key=lambda j: self.slots[j].req.id)
                    if self.slots[v].req.id > s.req.id:
                        self._preempt(v)
                        continue  # retry with the freed pages
                    self._preempt(i)
                    break
                s.req.finish_reason = "length"
                self._emit(s.req, None)
                self._free_slot(i)
                break
            else:
                keep.append(i)
        self.pool.flush(self.kv)
        # a slot kept earlier may have been a later slot's victim
        return [i for i in keep if self.slots[i].req is not None]

    def _next_pending(self) -> Request | None:
        if self._waitq:
            return self._waitq.popleft()
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                continue
            req = self._next_pending()
            if req is None:
                break
            # clamp client-supplied max_tokens, then keep the prompt's
            # tail so prompt + generation fit the slot
            req.max_tokens = max(1, min(req.max_tokens, self.max_seq - 1))
            if len(req.prompt_ids) >= self.max_seq:
                keep = max(1, self.max_seq - req.max_tokens - 1)
                req.prompt_ids = req.prompt_ids[-keep:]
                if req.embeds is not None:  # keep the rows aligned
                    req.embeds = req.embeds[-keep:]
            if self.pool is not None:
                if not self.pool.ensure(i, len(req.prompt_ids) + 1):
                    # pool dry: return any partial grant, hold the request
                    # until a resident slot finishes or is preempted
                    self.pool.release(i)
                    self._waitq.appendleft(req)
                    break
                self.pool.flush(self.kv)
            slot.req = req
            slot.prefill_off = 0
            slot.prefilling = True
            slot.cur_token = req.prompt_ids[-1]
            slot.generated = []
            self.kv.reset_slot(i)
            self.pos_host[i] = 0
            if self.d_kv is not None:
                self.d_kv.reset_slot(i)
            if self.is_eagle:
                self.bufs["feat"][i] = 0.0
            if self.prefix_cache is not None and req.embeds is None:
                hit = self.prefix_cache.match(req.prompt_ids[:-1])
                # a speculating scheduler's entries carry the draft
                # cache's prefix too, an EAGLE one's the carried feature
                if hit is not None and (not self.is_eagle
                                        or "feat" in hit[1]):
                    n, saved = hit
                    self.kv.restore_slot_prefix(i, saved)
                    self.pos_host[i] = n
                    if self.d_kv is not None:
                        self.d_kv.restore_slot_prefix(i, saved["draft"])
                    if self.is_eagle:
                        self.bufs["feat"][i] = saved["feat"]
                    slot.prefill_off = n
                    log.debug(f"req {req.id}: prefix cache hit ({n} tok)")
                    key = tuple(req.prompt_ids[:n])
                    if n == len(req.prompt_ids) - 1 and key in self._pin_reqs:
                        # the whole prefix is an entry: no prefill will
                        # store it, so pin the entry as it is
                        self.prefix_cache.put(list(key), saved, pin=True)
                        self._pin_reqs.discard(key)
            self.penalty.reset_slot(i)
            if (req.penalty_repeat != 1.0 or req.penalty_freq
                    or req.penalty_present):
                # penalties count the prompt's tokens too
                self.penalty.seed_slot(i, req.prompt_ids)
            slot.seed = (req.seed if req.seed is not None
                         else self.hp.sampler.seed + req.id * 7919 + i)
            self.n_requests += 1
            self.n_prompt_tokens += len(req.prompt_ids)
            log.debug(f"req {req.id} -> slot {i}")

    # -- device ticks -----------------------------------------------------------

    @torch.no_grad()
    def _prefill_tick(self) -> bool:
        """Advance every prefilling slot by one chunk. True if any ran."""
        C = self.chunk
        tokens = np.zeros((self.S, C), np.int64)
        positions = np.full((self.S, C), -1, np.int64)
        active = np.zeros(self.S, bool)
        n_real = np.zeros(self.S, np.int64)
        # slots whose chunk takes the request's rows: (slot, rows)
        overlay: list[tuple[int, torch.Tensor]] = []
        stores: list[tuple[int, list[int]]] = []
        for i, slot in enumerate(self.slots):
            if slot.req is None or not slot.prefilling:
                continue
            prompt = slot.req.prompt_ids[:-1]  # the last token feeds decode
            off = slot.prefill_off
            part = prompt[off:off + C]
            if not part:
                self._start_decoding(i)
                continue
            tokens[i, :len(part)] = part
            positions[i, :len(part)] = off + np.arange(len(part))
            active[i] = True
            n_real[i] = len(part)
            if slot.req.embeds is not None:
                overlay.append((i, slot.req.embeds[off:off + len(part)]))
            slot.prefill_off += len(part)
            self.pos_host[i] = slot.prefill_off  # the chunk's writes
            if slot.prefill_off >= len(prompt):
                self._start_decoding(i)
                if self.prefix_cache is not None and slot.req.embeds is None:
                    stores.append((i, prompt))
        if not active.any():
            return False
        dev = self.device
        args = (torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev))
        act = torch.from_numpy(active).to(dev)
        rows = self._overlay(self.model, args[0], overlay)
        if self.is_eagle:
            self._eagle_prefill_chunk(*args, act, n_real, rows)
        else:
            self.model(self.kv, *args, active=act, logits_mode="none",
                       embeds=rows)
            if self.draft is not None:
                # the same rows; the other slots through its own table
                d_rows = (rows if rows is None
                          or self.draft.embed is self.model.embed
                          else self._overlay(self.draft, args[0], overlay))
                self.draft(self.d_kv, *args, active=act, logits_mode="none",
                           embeds=d_rows)
        for i, prefix in stores:
            pin = tuple(prefix) in self._pin_reqs
            if pin or len(prefix) >= self.prefix_cache.min_len:
                saved = self.kv.save_slot_prefix(i, len(prefix))
                if self.d_kv is not None:
                    saved["draft"] = self.d_kv.save_slot_prefix(i,
                                                                len(prefix))
                if self.is_eagle:
                    saved["feat"] = self.bufs["feat"][i].clone()
                self.prefix_cache.put(prefix, saved, pin=pin)
                self._pin_reqs.discard(tuple(prefix))
        return True

    def _start_decoding(self, i: int) -> None:
        """Slot i's prompt is in the cache: it decodes from the next tick,
        its stream from its first draw (ticks it sat out while prefilling
        advanced the counter), its position known to the fast path."""
        slot = self.slots[i]
        slot.prefilling = False
        self.draws.reset_slot(i, slot.seed)
        self._seed_pos(i, len(slot.req.prompt_ids) - 1)

    @staticmethod
    def _overlay(model: LlamaModel, tokens: torch.Tensor,
                 overlay: list[tuple[int, torch.Tensor]]
                 ) -> torch.Tensor | None:
        """A chunk's input rows [S, C, dim] bf16: model's embedding lookup,
        with each overlay slot's real lanes taking its request's rows
        (None without such a slot: the forward looks up itself)."""
        if not overlay:
            return None
        x = model.embed.lookup(tokens).to(torch.bfloat16)
        for i, r in overlay:
            x[i, :r.shape[0]] = r
        return x

    def _eagle_prefill_chunk(self, tokens: torch.Tensor,
                             positions: torch.Tensor, active: torch.Tensor,
                             n_real: np.ndarray,
                             rows: torch.Tensor | None = None) -> None:
        """A target chunk keeping its final hidden states, then the head's
        chunk: lane 0 pairs with each slot's carried feature, lane i with
        the chunk's feature at lane i - 1. The carry becomes the feature
        at each slot's last real lane (n_real[s] - 1): the padded lanes'
        features never leak into it. rows: the target's input rows (an
        embed request's); the head reads the token ids."""
        feat = self.bufs["feat"]
        _, feats = self.model(self.kv, tokens, positions, active=active,
                              logits_mode="none", return_final_hidden=True,
                              embeds=rows)
        feats = feats.float()
        eagle_forward(self.draft, self.d_kv, tokens,
                      torch.cat([feat[:, None], feats[:, :-1]], dim=1),
                      positions, active=active, logits_mode="none")
        n = torch.from_numpy(n_real).to(self.device)
        last = feats.gather(1, (n - 1).clamp(min=0)[:, None, None].expand(
            -1, 1, feats.shape[-1]))[:, 0]
        feat.copy_(torch.where((active & (n > 0))[:, None], last, feat))

    def _cancel_tick(self) -> None:
        """Free slots whose consumer aborted (e.g. a stop-string match)."""
        for i, s in enumerate(self.slots):
            if s.req is not None and s.req.cancelled:
                if not s.req.finish_reason:
                    s.req.finish_reason = "stop"
                self._emit(s.req, None)
                self._free_slot(i)

    @torch.no_grad()
    def _decode_tick(self) -> bool:
        decoding = [i for i, s in enumerate(self.slots)
                    if s.req is not None and not s.prefilling]
        if not decoding:
            return self._drain()
        if self.draft is not None:
            return self._spec_decode_tick(decoding)
        decoding, fast = self._plain_grants(decoding)
        if not decoding:
            return True  # preemptions / finishes were work
        greedy = self._slot_settings(decoding)
        b = self.bufs
        vocab = self.cfg.llm.vocab_size
        draws = None if greedy else self.draws
        g = self.graphs.step(("tick", greedy), lambda: (_tick_step(
            self.model, self.kv, self.penalty, b, vocab, draws), b))
        reqs = [self.slots[i].req for i in decoding]
        b["step"].zero_()
        for _ in range(self.horizon):
            g()
        # every active slot wrote `horizon` positions (none past the end)
        for i in decoding:
            self.pos_host[i] = min(self.pos_host[i] + self.horizon,
                                   self.max_seq)
        # tokens, logprobs, top ids and logprobs, and the positions after
        # the tick (as the JAX scheduler's capacity check reads them)
        handle = self._fetch((b["out_tok"], b["out_lp"], b["out_ti"],
                              b["out_tlp"], self.kv.pos))
        self._dispatched(("plain", decoding, reqs, handle), single=not fast)
        return True

    def _plain_grants(self, decoding: list[int]) -> tuple[list, bool]:
        """The plain tick's pages (paged mode): the fast path's, or a
        drain and the exact grants of a slow tick. Returns the slots that
        decode and whether the tick is fast (double-buffered)."""
        if self.pool is None:
            return decoding, True
        if self._pool_fast(decoding):
            self.pool.flush(self.kv)
            return decoding, True
        self.n_pool_slow_ticks += 1
        self._drain()
        return self._ensure_decode_pages(decoding, self.horizon), False

    def _pool_fast(self, decoding: list[int]) -> bool:
        """Paged mode, JAX's fast path: every decoding slot's drained
        position is known and the pool covers two ticks past it (a tick
        may still be in flight); where a grant was needed and the pool
        has slack, two more pages, so the next table flushes come later.
        False: the tick must drain and grant exactly."""
        for i in decoding:
            need = int(self._pos_drained[i]) + 2 * self.horizon
            if i not in self._pos_known or not self.pool.ensure(i, need):
                return False
            if self.pool.dirty and self.pool.n_free_for(i) > 2:
                self.pool.ensure(i, need + 2 * self.pool.page_size)
        return True

    def _slot_settings(self, decoding: list[int]) -> bool:
        """Fill the static [S] buffers with the decoding slots' inputs —
        tokens, active, temperature, top_k, top_p, repeat / frequency /
        presence penalties — in one copy from pinned memory (dispatch
        waits for nothing). A slot still owned by the request of the tick
        in flight keeps the token that tick left in the token buffer (the
        drain has not set its cur_token). True if every slot is greedy."""
        S = self.S
        host = np.zeros((9, S), np.float64)
        tokens, active, temp, top_k, top_p, pen, pfreq, ppres, carry = host
        top_p[:], pen[:] = 1.0, 1.0
        greedy = True
        for i in decoding:
            r = self.slots[i].req
            tokens[i] = self.slots[i].cur_token
            active[i] = 1.0
            temp[i], top_k[i], top_p[i] = r.temperature, r.top_k, r.top_p
            pen[i], pfreq[i], ppres[i] = (r.penalty_repeat, r.penalty_freq,
                                          r.penalty_present)
            greedy = greedy and r.temperature <= 0
        if self._inflight is not None:
            for j, r in zip(self._inflight[1], self._inflight[2]):
                if self.slots[j].req is r:
                    carry[j] = 1.0
        stage = torch.from_numpy(host)
        if self.device.type == "cuda":
            stage = stage.pin_memory()
        stage = stage.to(self.device, non_blocking=True)
        b = self.bufs
        b["tok"].copy_(torch.where(stage[8] > 0, b["tok"],
                                   stage[0].to(torch.int64)))
        for j, name in enumerate(("active", "temp", "top_k", "top_p", "pen",
                                  "pfreq", "ppres"), start=1):
            b[name].copy_(stage[j] > 0 if name == "active" else stage[j])
        return greedy

    def _fetch(self, parts: tuple) -> tuple:
        """One copy of the tick's outputs to the host, in one f64 vector
        (exact for each of them): on the card an asynchronous copy into
        pinned memory right after the tick's replays and an event, so the
        next tick's replays, which overwrite the static buffers, come
        after it in stream order. Returns (host vector, event or None,
        sizes)."""
        flat = torch.cat([t.double().flatten() for t in parts])
        sizes = [t.numel() for t in parts]
        if flat.device.type != "cuda":
            return flat, None, sizes
        host = torch.empty(flat.numel(), dtype=torch.float64,
                           pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, sizes

    @staticmethod
    def _fetched(handle: tuple) -> list[np.ndarray]:
        """The parts of a fetch, waiting for its copy alone."""
        host, event, sizes = handle
        if event is not None:
            event.synchronize()
        return np.split(host.numpy().copy(), np.cumsum(sizes[:-1]))

    def _dispatched(self, record: tuple, single: bool) -> None:
        """Process the tick in flight (its copy overlaps this tick's
        replays) and put this one in flight; a single-buffered tick is
        processed at once."""
        prev, self._inflight = self._inflight, record
        if prev is not None:
            self._drain_record(prev)
        if single:
            self._drain()

    def _drain(self) -> bool:
        """Process the tick in flight, if any. True if there was one."""
        record, self._inflight = self._inflight, None
        if record is None:
            return False
        self._drain_record(record)
        return True

    def _drain_record(self, record: tuple) -> None:
        """Deliver a dispatched tick's results to the requests its slots
        still hold (a slot reused since dispatch is skipped: its results
        are void)."""
        if record[0] == "spec":
            self._drain_spec(*record[1:])
            return
        _, decoding, reqs, handle = record
        toks, lps, top_i, top_lp, pos = self._fetched(handle)
        H = self.horizon
        toks = toks.astype(np.int64).reshape(self.S, H).tolist()
        lps = lps.reshape(self.S, H).tolist()
        top_i = top_i.astype(np.int64).reshape(self.S, H, -1).tolist()
        top_lp = top_lp.reshape(self.S, H, -1).tolist()
        pos = pos.astype(np.int64).tolist()
        owned = [i for i, r in zip(decoding, reqs) if self.slots[i].req is r]
        for i in owned:
            # an upper bound (the tick after it may be in flight): page
            # grants may only over-cover
            self._seed_pos(i, pos[i] + H)
        for i in owned:
            s = self.slots[i]
            for h in range(H):
                t = int(toks[i][h])
                s.cur_token = t
                if s.req.logprobs > 0:
                    n = min(s.req.logprobs, N_TOP)
                    s.req.token_logprobs.append(float(lps[i][h]))
                    s.req.top_logprobs.append(
                        list(zip(top_i[i][h][:n], top_lp[i][h][:n])))
                if self._deliver(i, t, pos[i] + h + 1 >= self.max_seq - 1):
                    break

    def _deliver(self, i: int, t: int, out_of_room: bool) -> bool:
        """Emit token t of slot i's request. When it finishes the request
        (cancelled, a stop token, max_tokens, or no room left), end it,
        free the slot and return True."""
        s = self.slots[i]
        req = s.req
        s.generated.append(t)
        req.n_generated += 1
        self.n_tokens_generated += 1
        self._emit(req, t)
        if req.cancelled:
            req.finish_reason = req.finish_reason or "stop"
        elif t in req.stop_ids:
            req.finish_reason = "stop"
        elif req.n_generated >= req.max_tokens or out_of_room:
            req.finish_reason = "length"
        else:
            return False
        self._emit(req, None)
        self._free_slot(i)
        return True

    @torch.no_grad()
    def _spec_decode_tick(self, decoding: list[int]) -> bool:
        """spec_horizon steps of batched chain or tree speculation (or
        EAGLE's) for every decoding slot, one graph replay a step whether
        the slots sample or not; one host fetch, drained with the next
        tick on the dense cache, at once on the pool."""
        tpl, H = self.spec_template, self.spec_horizon
        D, N = tpl.max_depth, tpl.n_nodes
        if self.pool is not None:
            # the positions after a tick depend on its acceptance: pool
            # ticks stay single-buffered. Each step writes N entries, of
            # which the accepted ones stay: up to H * (D + 1) committed
            # plus one tree in flight
            self._drain()
            decoding = self._ensure_decode_pages(decoding, H * (D + 1) + N)
            if not decoding:
                return True
        greedy = self._slot_settings(decoding)
        b = self.bufs
        wor = bool(self.hp.spec_wor)
        draws = None if greedy else self.draws
        args = (self.model, self.draft, self.kv, self.d_kv, b)
        if self.is_eagle:
            key, build = ("eagle", wor, greedy), lambda: eagle_sample_body(
                *args, D, None if tpl.is_chain else tpl, wor, draws)
        elif tpl.is_chain:
            key, build = ("spec", greedy), lambda: sample_step(*args, D,
                                                               draws)
        else:
            key, build = ("tree", wor, greedy), lambda: tree_sample_body(
                *args, tpl, wor, draws)
        g = self.graphs.step(key, lambda: (build(), b))
        reqs = [self.slots[i].req for i in decoding]
        b["step"].zero_()
        for _ in range(H):
            g()
        handle = self._fetch((b["spec_emitted"], b["spec_counts"], b["root"],
                              self.kv.pos))
        self._dispatched(("spec", decoding, reqs, handle),
                         single=self.pool is not None)
        return True

    def _drain_spec(self, decoding: list[int], reqs: list,
                    handle: tuple) -> None:
        """A spec tick's results: the spec_* counters over every slot it
        ran, then each still-owned slot's accepted tokens."""
        tpl, H, S = self.spec_template, self.spec_horizon, self.S
        D, N = tpl.max_depth, tpl.n_nodes
        emitted, counts_h, next_tok, pos_now = self._fetched(handle)
        emitted = emitted.astype(np.int64).reshape(H, S, D + 1).tolist()
        counts_h = counts_h.astype(np.int64).reshape(H, S)
        next_tok = next_tok.astype(np.int64).tolist()
        pos_now = pos_now.astype(np.int64)
        if self._inflight is None:
            # nothing was dispatched after it: the positions of the slots
            # it still holds are kv.pos
            for i, r in zip(decoding, reqs):
                if self.slots[i].req is r:
                    self.pos_host[i] = int(pos_now[i])
        # the committed length before the tick: every step advanced each
        # slot by its count
        pos_pre = (pos_now - counts_h.sum(axis=0)).tolist()
        counts = counts_h.tolist()
        room = self.max_seq - H * (D + 1) - N
        self.n_spec_steps += H * len(decoding)
        self.n_spec_drafted += H * len(decoding) * D
        self.n_spec_accepted += (sum(counts[h][i] for h in range(H)
                                     for i in decoding)
                                 - H * len(decoding))
        for i, r in zip(decoding, reqs):
            if self.slots[i].req is not r:
                continue  # reused since dispatch: the results are void
            self.slots[i].cur_token = int(next_tok[i])
            ids = [emitted[h][i][j] for h in range(H)
                   for j in range(counts[h][i])]
            for n_out, t in enumerate(ids, start=1):
                if self._deliver(i, int(t), pos_pre[i] + n_out >= room):
                    break

    def step(self) -> bool:
        """One scheduler iteration; True if work was done. Prefill has
        priority (new requests start fast), but decoding slots get a tick
        at least every `decode_every` iterations, so a stream of long
        prompts cannot starve running generations."""
        self._run_jobs()
        self._cancel_tick()
        self._admit()
        self._tick += 1
        every = max(int(self.hp.decode_every), 1)
        if self._prefill_tick():
            if self._tick % every == 0:
                self._decode_tick()
            return True
        return self._decode_tick()

    # -- metrics and the thread ---------------------------------------------

    @staticmethod
    def _pct(window, q: float) -> float:
        if not window:
            return 0.0
        xs = sorted(window)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def metrics(self) -> dict:
        """Counters and latency percentiles for /metrics, over sliding
        windows of the last 512 requests: ttft = submit -> first token,
        latency = submit -> done."""
        up = max(time.time() - self.started_at, 1e-9)
        out = {
            "requests_total": self.n_requests,
            "prompt_tokens_total": self.n_prompt_tokens,
            "generated_tokens_total": self.n_tokens_generated,
            "slots_active": self.n_active,
            "slots_total": self.S,
            "queue_depth": self.pending.qsize(),
            "uptime_seconds": up,
            "generated_tokens_per_second": self.n_tokens_generated / up,
            "prefix_cache_hits": (self.prefix_cache.hits
                                  if self.prefix_cache else 0),
            "prefix_cache_misses": (self.prefix_cache.misses
                                    if self.prefix_cache else 0),
        }
        if self.n_spec_steps:
            out["spec_steps_total"] = self.n_spec_steps
            out["spec_drafted_total"] = self.n_spec_drafted
            out["spec_accepted_total"] = self.n_spec_accepted
            out["spec_accept_rate"] = (self.n_spec_accepted
                                       / max(self.n_spec_drafted, 1))
            out["spec_tokens_per_step"] = (
                (self.n_spec_accepted + self.n_spec_steps)
                / self.n_spec_steps)
        if self.pool is not None:
            out["paged_pages_total"] = self.pool.n_pages
            out["paged_pages_free"] = self.pool.n_free
            out["paged_slow_ticks"] = self.n_pool_slow_ticks
            out["paged_preemptions_total"] = self.n_preemptions
            out["paged_deferred_requests"] = len(self._waitq)
        for name, win in (("ttft_seconds", self._ttft),
                          ("request_latency_seconds", self._req_latency)):
            for q in (0.5, 0.9, 0.99):
                out[f"{name}_p{int(q * 100)}"] = self._pct(win, q)
        return out

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self.step()
            except Exception:  # noqa: BLE001 — the server must keep serving
                # a failed step fails every in-flight request and the
                # scheduler goes on with the next ones
                log.exception("scheduler step failed; resetting slots")
                self._inflight = None  # its results go with the slots
                for i, s in enumerate(self.slots):
                    if s.req is not None:
                        s.req.finish_reason = "error"
                        self._emit(s.req, None)
                        self._free_slot(i)
                busy = False
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()


def _tick_step(model: LlamaModel, kv: KVCache, penalty: PenaltyState,
               bufs: dict, vocab: int, draws: DrawState | None):
    """The body of one decode step of a tick over the scheduler's
    buffers: the forward, every slot's sampling distribution after its
    penalties, the token (the argmax where draws is None, an all-greedy
    tick; else each slot's draw from its stream, one-hot for a greedy
    slot), its logprob and the penalty push, and the raw logits'
    logsumexp and top N_TOP, written to column `step` of the outputs; the
    token feeds the next step."""
    b = bufs
    step = b["step"]

    def record(name, t):
        b[name].index_copy_(1, step, t[:, None])

    def body():
        active = b["active"]
        positions = torch.where(active, kv.pos.long(), -1)[:, None]
        logits = model(kv, b["tok"][:, None], positions, active=active,
                       logits_mode="last")
        probs = sample_dist_batched(
            logits, b["temp"], b["top_k"], b["top_p"], state=penalty,
            penalty_repeat=b["pen"], penalty_freq=b["pfreq"],
            penalty_present=b["ppres"], vocab_size=vocab)
        # logprobs of the RAW model logits (before penalties and
        # temperature): the OpenAI fields report the model's
        # distribution, not the sampling distribution
        lf = logits.float()[:, :vocab]
        lse = torch.logsumexp(lf, dim=-1)
        tv, ti = torch.topk(lf, N_TOP, dim=-1)
        record("out_ti", ti)
        record("out_tlp", tv - lse[:, None])
        tok = categorical_from_dist(probs, draws)
        penalty.push(tok, active)
        b["tok"].copy_(tok)
        record("out_tok", tok)
        record("out_lp", lf.gather(1, tok[:, None])[:, 0] - lse)
        step.add_(1)

    return body
