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
chain of hp.spec_k. A chain runs chain_spec_sample_scan: each slot
drafts with its own sampler settings and generator, one target forward
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
logprobs into static [S, horizon] outputs through a step counter. In an
all-greedy tick the graph holds the whole step: forward, sampler chain,
argmax, penalty push and logprobs; where any slot samples, it holds the
forward, the distributions and the logprobs' parts, and each slot's draw
from its own generator and the push run eagerly after each replay. A
spec tick whose slots all decode greedily draws nothing, and replays
one graph per speculative step; where any slot samples, its draws come
between the draft forwards and the tick runs eagerly. The prefill tick
stays eager.

With an EAGLE head (speculative/eagle.py) the draft is the head: its
dense int8 cache sits beside the target's, and each slot carries the
target feature f32 [dim] paired with its next token. A prefill chunk
runs the target with its final hidden states, then the head over the
same tokens, lane i paired with the feature of lane i - 1 (lane 0 with
the carried one); the carry becomes the feature at each slot's last
real lane. Prefix-cache entries keep the feature too (an entry without
one is no hit), and a preempted slot rebuilds it with both caches. Its
ticks run eagle_sample_step (a chain of spec_k) or
eagle_tree_sample_step (hp.spec_tree), replayed when every slot is
greedy, as the draft model's.

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
lookup. Double-buffered ticks are not ported: like
the plain tick, the spec tick syncs once. Each tick's one host fetch
also refreshes a host mirror of every slot's cache position (pos_host),
which admission and prefill keep up to date between ticks, so the paged
pool grants pages without reading the card.
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
from ..sampling.sampler import (PenaltyState, categorical_from_dist,
                                sample_dist_batched)
from ..speculative.chain import chain_spec_sample_scan, greedy_sample_step
from ..speculative.device_tree import (TreeTemplate, greedy_tree_sample_step,
                                       tree_spec_scan)
from ..speculative.eagle import (EagleHead, eagle_forward, eagle_spec_scan,
                                 eagle_tree_spec_scan,
                                 greedy_eagle_sample_step)
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
    # explicit per-request seed (OpenAI `seed`): the slot's generator is
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
            self.draft = draft.to(self.device)
            self.d_kv = self._new_cache(draft.llm)
        self.penalty = PenaltyState.create(
            self.S, max(self.hp.sampler.penalty_last_n, 1), self.device)
        # one generator per slot, re-seeded at each admission
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(self.S)]
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
        self._ids = itertools.count()
        self._tick = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def _new_cache(self, llm, **paged) -> KVCache:
        """A dense (or, with n_pages, paged) cache of llm's geometry for
        every slot: over the model's rank group when it has one."""
        args = (llm.n_layers, self.S, self.max_seq, llm.n_kv_heads,
                llm.head_size)
        if self.tp:
            return self.model.create_cache(*args, **paged)
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
        self.bufs, self.penalty, self.generators = {}, None, []
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

    def _ensure_decode_pages(self, decoding: list[int],
                             extra: int) -> list[int]:
        """Paged mode: grow each decoding slot's pages to cover the `extra`
        positions this tick may write. When the pool runs dry the YOUNGEST
        page-holding request is preempted first (least work lost); a slot
        that is itself the youngest preempts itself. A lone request the
        pool cannot serve finishes with 'length'. The positions come from
        the host mirror: no read of the card."""
        pos = self.pos_host
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
            seed = (req.seed if req.seed is not None
                    else self.hp.sampler.seed + req.id * 7919 + i)
            self.generators[i].manual_seed(seed)
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
                slot.prefilling = False
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
                slot.prefilling = False
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
            return False
        if self.draft is not None:
            return self._spec_decode_tick(decoding)
        if self.pool is not None:
            decoding = self._ensure_decode_pages(decoding, self.horizon)
            if not decoding:
                return True  # preemptions / finishes were work
        gens = self._slot_settings(decoding)
        b = self.bufs
        greedy = all(g is None for g in gens)
        vocab = self.cfg.llm.vocab_size
        g = self.graphs.step(("tick", greedy), lambda: (_tick_step(
            self.model, self.kv, self.penalty, b, vocab, greedy), b))
        b["step"].zero_()
        for h in range(self.horizon):
            out = g()
            if not greedy:
                probs, lf, lse = out
                tok = categorical_from_dist(probs, gens)
                self.penalty.push(tok, b["active"])
                b["tok"].copy_(tok)
                b["out_tok"][:, h] = tok
                b["out_lp"][:, h] = lf.gather(1, tok[:, None])[:, 0] - lse
        # one host fetch per tick: tokens, logprobs, top ids and
        # logprobs, and the positions after the tick (as the JAX
        # scheduler's capacity check reads them), in one f64 vector (exact
        # for each of them)
        parts = (b["out_tok"], b["out_lp"], b["out_ti"], b["out_tlp"],
                 self.kv.pos)
        flat = torch.cat([t.double().flatten() for t in parts]).cpu().numpy()
        toks, lps, top_i, top_lp, pos_host = np.split(
            flat, np.cumsum([t.numel() for t in parts[:-1]]))
        toks = toks.astype(np.int64).reshape(self.S, -1).tolist()
        lps = lps.reshape(self.S, -1).tolist()
        top_i = top_i.astype(np.int64).reshape(self.S, self.horizon,
                                               -1).tolist()
        top_lp = top_lp.reshape(self.S, self.horizon, -1).tolist()
        self.pos_host = pos_host = pos_host.astype(np.int64).tolist()
        for i in decoding:
            s = self.slots[i]
            for h in range(self.horizon):
                t = int(toks[i][h])
                s.cur_token = t
                if s.req.logprobs > 0:
                    n = min(s.req.logprobs, N_TOP)
                    s.req.token_logprobs.append(float(lps[i][h]))
                    s.req.top_logprobs.append(
                        list(zip(top_i[i][h][:n], top_lp[i][h][:n])))
                if self._deliver(i, t, pos_host[i] + h + 1
                                 >= self.max_seq - 1):
                    break
        return True

    def _slot_settings(self, decoding: list[int]) -> list:
        """Fill the static [S] buffers with the decoding slots' inputs —
        tokens, active, temperature, top_k, top_p, repeat / frequency /
        presence penalties — and return each slot's generator (None for a
        greedy slot, which draws nothing)."""
        S = self.S
        tokens = torch.zeros(S, dtype=torch.int64)
        active = torch.zeros(S, dtype=torch.bool)
        temp, top_k, top_p = (torch.zeros(S),
                              torch.zeros(S, dtype=torch.int64),
                              torch.ones(S))
        pen, pfreq, ppres = torch.ones(S), torch.zeros(S), torch.zeros(S)
        gens: list[torch.Generator | None] = [None] * S
        for i in decoding:
            r = self.slots[i].req
            tokens[i] = self.slots[i].cur_token
            active[i] = True
            temp[i], top_k[i], top_p[i] = r.temperature, r.top_k, r.top_p
            pen[i], pfreq[i] = r.penalty_repeat, r.penalty_freq
            ppres[i] = r.penalty_present
            if r.temperature > 0:
                gens[i] = self.generators[i]
        for name, t in zip(("tok", "active", "temp", "top_k", "top_p", "pen",
                            "pfreq", "ppres"),
                           (tokens, active, temp, top_k, top_p, pen, pfreq,
                            ppres)):
            self.bufs[name].copy_(t)
        return gens

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
        """spec_horizon steps of batched chain or tree speculation for
        every decoding slot, one host fetch at the end."""
        tpl, H = self.spec_template, self.spec_horizon
        D, N = tpl.max_depth, tpl.n_nodes
        if self.pool is not None:
            # each step writes N entries, of which the accepted ones
            # stay: up to H * (D + 1) committed plus one tree in flight
            decoding = self._ensure_decode_pages(decoding, H * (D + 1) + N)
            if not decoding:
                return True
        S = self.S
        gens = self._slot_settings(decoding)
        b = self.bufs
        wor = bool(self.hp.spec_wor)
        if self.is_eagle:
            emitted, counts, next_tok = self._eagle_steps(gens, wor)
        elif all(g is None for g in gens):
            # nothing is drawn: each step replays one graph
            if tpl.is_chain:
                key, build = ("spec",), lambda: greedy_sample_step(
                    self.model, self.draft, self.kv, self.d_kv, b, D)
            else:
                key, build = ("tree", wor), lambda: (
                    greedy_tree_sample_step(self.model, self.draft, self.kv,
                                            self.d_kv, b, tpl, wor))
            g = self.graphs.step(key, lambda: (build(), b))
            b["step"].zero_()
            for _ in range(H):
                g()
            emitted, counts, next_tok = (b["spec_emitted"],
                                         b["spec_counts"], b["root"])
        elif tpl.is_chain:
            emitted, counts, next_tok = chain_spec_sample_scan(
                self.model, self.draft, self.kv, self.d_kv, b["tok"], H, D,
                b["active"], gens, b["temp"], b["top_k"], b["top_p"])
        else:
            emitted, counts, next_tok = tree_spec_scan(
                self.model, self.draft, self.kv, self.d_kv, b["tok"], H, tpl,
                b["active"], gens, b["temp"], b["top_k"], b["top_p"],
                sample="wor" if wor else True)
        # one host fetch per tick
        flat = torch.cat([emitted.flatten(), counts.flatten(), next_tok,
                          self.kv.pos.long()]).cpu()
        n_e = emitted.numel()
        emitted = flat[:n_e].reshape(H, S, D + 1).tolist()
        counts_h = flat[n_e:n_e + H * S].reshape(H, S)
        next_tok = flat[n_e + H * S:n_e + H * S + S].tolist()
        # the committed length before the tick: every step advanced each
        # slot by its count
        pos_now = flat[n_e + H * S + S:]
        self.pos_host = pos_now.tolist()
        pos_pre = (pos_now - counts_h.sum(dim=0)).tolist()
        counts = counts_h.tolist()
        room = self.max_seq - H * (D + 1) - N
        self.n_spec_steps += H * len(decoding)
        self.n_spec_drafted += H * len(decoding) * D
        self.n_spec_accepted += (sum(counts[h][i] for h in range(H)
                                     for i in decoding)
                                 - H * len(decoding))
        for i in decoding:
            self.slots[i].cur_token = int(next_tok[i])
            ids = [emitted[h][i][j] for h in range(H)
                   for j in range(counts[h][i])]
            for n_out, t in enumerate(ids, start=1):
                if self._deliver(i, int(t), pos_pre[i] + n_out >= room):
                    break
        return True

    def _eagle_steps(self, gens: list, wor: bool) -> tuple:
        """spec_horizon EAGLE steps over the static buffers (a chain of
        spec_k, or the template's tree): (emitted [H, S, D + 1], counts
        [H, S], next tokens [S]); the carried features move in bufs
        feat."""
        tpl, H, b = self.spec_template, self.spec_horizon, self.bufs
        tree = None if tpl.is_chain else tpl
        if all(g is None for g in gens):
            # nothing is drawn: each step replays one graph
            g = self.graphs.step(("eagle", wor), lambda: (
                greedy_eagle_sample_step(self.model, self.draft, self.kv,
                                         self.d_kv, b, tpl.max_depth, tree,
                                         wor), b))
            b["step"].zero_()
            for _ in range(H):
                g()
            return b["spec_emitted"], b["spec_counts"], b["root"]
        args = (self.model, self.draft, self.kv, self.d_kv, b["tok"],
                b["feat"], H)
        sets = (b["active"], gens, b["temp"], b["top_k"], b["top_p"])
        if tree is None:
            emitted, counts, next_tok, feat = eagle_spec_scan(
                *args, tpl.max_depth, *sets, sample=True)
        else:
            emitted, counts, next_tok, feat = eagle_tree_spec_scan(
                *args, tpl, *sets, sample="wor" if wor else True)
        b["feat"].copy_(feat)
        return emitted, counts, next_tok

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
               bufs: dict, vocab: int, greedy: bool):
    """The body of one decode step of a tick over the scheduler's
    buffers: the forward, every slot's sampling distribution after its
    penalties, and the raw logits' logsumexp and top N_TOP, written to
    column `step` of the outputs. Greedy (no slot draws): also the
    argmax, its logprob and the penalty push, and the argmax feeds the
    next step. Otherwise it returns (distributions, raw logits f32 [S,
    vocab], logsumexp [S]) for the eager draws."""
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
        out = None
        if greedy:
            tok = torch.argmax(probs, dim=-1)
            penalty.push(tok, active)
            b["tok"].copy_(tok)
            record("out_tok", tok)
            record("out_lp", lf.gather(1, tok[:, None])[:, 0] - lse)
        else:
            out = (probs, lf, lse)
        step.add_(1)
        return out

    return body
