"""OpenAI-compatible HTTP server over the continuous-batching scheduler.

  POST /completion, /completions, /v1/completions
  POST /chat/completions, /v1/chat/completions
  GET  /v1/models, /health, /metrics
  POST /v1/sessions; GET /v1/sessions; DELETE /v1/sessions/{id}

SSE streaming emits `data: {...}` chunks then `data: [DONE]`, with
UTF-8-safe text chunking; response bodies carry the JAX server's keys.
Built on the standard library's ThreadingHTTPServer (the machine with
the GPU has no aiohttp): each request gets a handler thread that
tokenizes, submits to the model's BatchScheduler and waits on a queue;
only the scheduler thread touches the device. Streams are chunked
`text/event-stream` responses.

A model name "main+draft" serves `main` with speculation from the model
dir `draft` (an EAGLE head's dir, general.architecture "eagle", drafts
with the head: speculative/eagle.py), "main+self:N" from a self-draft
over main's first N layers (speculative/chain.py): a scheduler of its
own, on the weights of main's plain context (loaded once, shared).
--spec-k sets the chain's draft length, --spec-tree W,... a token tree
in its place (widths per depth,
speculative/device_tree.py; --spec-wor verifies children drawn without
replacement by recursive rejection), --spec-horizon the speculative
steps per scheduler tick and --draft-head-rank factors the draft's
lm_head (an EAGLE head's too). Logprobs and penalties are not applied by
speculative ticks, so such requests on a speculative name get a 400, as
does a draft whose vocab differs from main's.

A vision-language model dir (vision.gguf beside weights.gguf, or an HF
InternVL checkpoint dir as it is: models/internvl.py) serves chat
requests whose content arrays hold `image_url` parts with data: URIs
(PNG or JPEG: core/image.py FORMATS; another format, a URL that is not
data:, or a prompt that ends in an image-context token gets a 400, as
does a malformed or corrupt image or one of more than core/image.py's
MAX_PIXELS). The images are decoded and preprocessed in
worker processes (serving/image_workers.py: numpy work in a handler
thread would hold the interpreter lock the scheduler thread needs
between its kernel launches; the workers import nothing of the host's
`__main__`), then encoded on the scheduler thread (BatchScheduler.call)
into the request's input rows, which ride the shared scheduler with the
text requests (Request.embeds). "vlm+self:N" and "vlm+<draft dir>" speculate with the
same rows in both models; an EAGLE head on a VLM gets a 400. A model
without a vision tower ignores image parts, as the JAX server does.

--tp N --dp M serves every model over N * M ranks (parallel/tp.py):
this process is rank 0 and runs the HTTP server and the schedulers; it
starts the N * M - 1 follower ranks itself, each applying rank 0's
forwards and cache operations to its shards (kv heads over tp, slots
and pages over dp). --dist-backend names the collectives' backend:
nccl (the default on cuda, one card a rank) or gloo (the default on the
cpu; on cuda it lets ranks share a card). A follower that dies ends the
server with an error. Every model kind serves under --tp: MoE models
(ServerContext(ep=) also splits their experts), VLM dirs (the tower on
rank 0) and "main+<eagle dir>" (the head sharded like a target layer).

Sessions are named, pinned prompt prefixes (an agent's long system
prompt, resumed by many requests without its prefill). POST /v1/sessions
with {"model", "prompt" (or chat "messages", taken as text), "id"
(optional), "save_path" (optional)} prefills the prompt once and pins
its KV snapshot in the model's prefix cache (engine/scheduler.py); with
"load_path" in place of a prompt it restores a saved session file
(kv/persist.py, the JAX server's layout: a file either package writes
loads in the other; a child process inflates it, off the interpreter
lock the scheduler thread needs). A request with {"session": id} then
has the session's tokens put before its own prompt, for completions and
chat. GET /v1/sessions lists them; DELETE /v1/sessions/{id} unpins and
drops the snapshot. An unknown session is a 404; an empty prompt, one
of max_seq - 2 tokens or more, a disabled prefix cache, or a file whose
groups do not fit the model a 400. Under --tp a saved file holds every
head, as one device's does.

--max-models N keeps at most N model contexts loaded: loading another
stops the least recently used idle one and gives its device memory back
(its scheduler, caches, step graphs and snapshots, and the weights no
live context shares: "main+self:N" keeps main's). A busy context and
the newest are never evicted (nor, in the JAX server, one whose
scheduler another context shares: here every context has its own);
sessions stay registered, and a later request re-prefills their tokens.

--pp N serves every model over N pipeline stages (parallel/pp.py: each
rank holds L / N layers and their cache, the residual goes from stage to
stage), alone: with --tp it exits with an error (JAX's server ignores
--tp there). A self-draft ("main+self:N"), a draft model's --spec-tree
and a VLM's speculation get a 400 under --pp, as in the JAX server; a
draft dir's chain, EAGLE chains and trees and plain VLM requests serve.
--tp T --sp N [--dp M] splits each dense cache's positions over N
sequence-parallel ranks (T * N * M ranks in all; the attention merges
the ranks' softmax states); every model and speculation serves there
(MoE models, VLM dirs, draft chains and --spec-tree, EAGLE heads), and
the paged pool exits with an error, as JAX asserts paged KV + sequence
parallel unsupported. --gspmd and --distributed exit with an error
naming ROADMAP §1 item 8b.

    python -m powerserve_tpu_torch serve -d <model_root> [--paged-pages N
        --page-size P] [--max-slots S] [--spec-k K | --spec-tree W,...
        [--spec-wor]] [--spec-horizon H] [--draft-head-rank R]
        [--max-models N] [--tp N [--sp N] [--dp M] | --pp N]
        [--dist-backend nccl|gloo] [--device cuda|cpu]

    curl -d '{"model": "model", "prompt": "You are ...", "id": "s1",
              "save_path": "s1.npz"}' localhost:8080/v1/sessions
    curl -d '{"model": "model", "session": "s1", "prompt": " Hi",
              "max_tokens": 16}' localhost:8080/v1/completions
    curl -X DELETE localhost:8080/v1/sessions/s1
    curl -d '{"model": "model", "id": "s1", "load_path": "s1.npz"}'
        localhost:8080/v1/sessions
"""

from __future__ import annotations

import argparse
import base64
import binascii
import contextlib
import functools
import gc
import json
import queue
import signal
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from ..core.config import HyperParams, ModelConfig, WorkspaceConfig
from ..core.device import resolve_device
from ..core.logging import get_logger
from ..engine.scheduler import BatchScheduler, Request
from ..kv.persist import load_session_apart, save_session
from ..models.internvl import InternVLModel, load_internvl, vlm_source
from ..models.llama import LlamaModel
from ..models.loader import (WEIGHT_FORMATS, gguf_architecture,
                             load_eagle_gguf, load_gguf_model)
from ..parallel.distributed import default_backend
from ..parallel.tp import check_mesh, start_rank_group
from ..speculative.chain import self_draft_model, with_draft_head
from ..speculative.draft_head import make_draft_head
from ..speculative.eagle import with_lm_head_lr
from ..tokenizer import Tokenizer
from .image_workers import ImageWorkers

log = get_logger("server")

# processes decoding and preprocessing request images
IMAGE_WORKERS = 4


class HTTPError(Exception):
    """An error answered with `status` and a plain-text body."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


class IncrementalDecoder:
    """UTF-8-safe streaming detokenizer: holds back text that ends in a
    partial multibyte sequence."""

    def __init__(self, tokenizer: Tokenizer):
        self.tok = tokenizer
        self.ids: list[int] = []
        self.emitted = 0

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tok.to_string(self.ids)
        if text.endswith("�"):
            return ""
        out = text[self.emitted:]
        self.emitted = len(text)
        return out

    def flush(self) -> str:
        text = self.tok.to_string(self.ids)
        out = text[self.emitted:]
        self.emitted = len(text)
        return out


class StopMatcher:
    """Stop-string detection over streamed text with holdback: text that
    could be the prefix of a stop string is buffered until disambiguated
    (`.push("<|e") -> ""` then `.push("nd|>") -> stop`)."""

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self.buf = ""
        self.stopped = False

    def push(self, piece: str) -> str:
        """Text safe to emit; sets .stopped when a stop string matched
        (the emitted text excludes it)."""
        if not self.stops:
            return piece
        self.buf += piece
        hits = [(self.buf.find(s), s) for s in self.stops if s in self.buf]
        if hits:
            i, _ = min(hits)
            out, self.buf = self.buf[:i], ""
            self.stopped = True
            return out
        hold = 0
        for s in self.stops:
            for ln in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:ln]):
                    hold = max(hold, ln)
                    break
        cut = len(self.buf) - hold
        out, self.buf = self.buf[:cut], self.buf[cut:]
        return out

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return out


@dataclass
class ModelContext:
    name: str
    scheduler: BatchScheduler
    tokenizer: Tokenizer
    # the vision tower and projector of a vision-language model
    vlm: InternVLModel | None = None
    # tokenizers build lazy tables at first use: handler threads encode
    # one at a time
    lock: threading.Lock = field(default_factory=threading.Lock)
    # requests between ServerContext.use and the end of their response
    # (changed under ServerContext._lock): a context with any is busy
    in_flight: int = 0

    def tokenize(self, text: str, **kw) -> list[int]:
        with self.lock:
            return self.tokenizer.tokenize(text, **kw)


class ServerContext:
    """Model registry: names resolve to model dirs under `model_root`,
    loaded at first use onto `device` (default cuda), each with its own
    scheduler thread. With tp * dp > 1 every model is sharded over that
    many ranks (parallel/tp.py), which the constructor starts over
    `dist_backend` (default: nccl on cuda, gloo on the cpu). max_models
    > 0 keeps at most that many contexts loaded (the least recently used
    idle one is evicted); `sessions` are the HTTP sessions by id.
    weight_format "w8" loads every model dir in the W8 format (run.py's
    --weight-format), "gguf" (default) in the file's formats. ep > 1
    splits an MoE model's experts over ep groups of tp ranks (tp * ep *
    dp ranks in all; JAX reaches it by a mesh, and `serve` has no flag
    for it either). sp > 1 splits the dense caches' positions over sp
    ranks (tp * ep * sp * dp in all); pp > 1, alone, the layers over pp
    stages (pp ranks)."""

    def __init__(self, model_root: str | Path, default_model: str = "",
                 hp: HyperParams | None = None,
                 device: str | torch.device | None = None,
                 tp: int = 1, dp: int = 1, dist_backend: str | None = None,
                 max_models: int = 0, weight_format: str = "gguf",
                 ep: int = 1, sp: int = 1, pp: int = 1):
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(f"weight format {weight_format!r}: gguf or w8")
        self.mxu = weight_format == "w8"
        self.root = Path(model_root)
        self.default_model = default_model
        self.hp = hp or HyperParams()
        self.device = resolve_device(device)
        self.models: dict[str, ModelContext] = {}
        self.max_models = int(max_models)
        self._lru: list[str] = []  # least recently used first
        self.sessions: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.image_workers: ImageWorkers | None = None
        self.tp, self.dp, self.ep = int(tp), int(dp), int(ep)
        self.sp, self.pp = int(sp), int(pp)
        check_mesh(self.tp, self.dp, self.ep, self.sp, self.pp)
        if self.sp > 1 and self.hp.paged_pages > 0:
            raise ValueError("paged KV + sequence parallel unsupported: the "
                             "pool is not split over sp")
        self.ranks = None
        world = self.tp * self.ep * self.sp * self.dp * self.pp
        if world > 1:
            backend = dist_backend or default_backend(self.device)
            log.info(f"{world} ranks (tp={self.tp}, ep={self.ep}, "
                     f"sp={self.sp}, pp={self.pp}, dp={self.dp}) over "
                     f"{backend} on {self.device.type}")
            self.ranks = start_rank_group(world, backend, self.device)
            self.device = self.ranks.device

    def _load(self, d: Path, source: str = "gguf"
              ) -> tuple[ModelConfig, LlamaModel]:
        """A model dir on this context's device, or over its ranks
        (source: RankGroup.load's)."""
        if self.ranks is not None:
            try:
                return self.ranks.load(d, self.tp, self.dp, self.mxu,
                                       self.ep, source=source, sp=self.sp,
                                       pp=self.pp)
            except ValueError as e:  # a model the mesh does not take
                raise HTTPError(400, f"model dir '{d.name}': {e}") from e
        return load_gguf_model(d, device=self.device, mxu=self.mxu)

    def _load_vlm(self, d: Path) -> InternVLModel:
        """A VLM dir (vlm_source): on this context's device, or the tower
        on rank 0 and the text model over the ranks."""
        text = None if self.ranks is None else functools.partial(self._load,
                                                                 d)
        return load_internvl(d, self.device, self.mxu, text=text)

    def resolve_dir(self, name: str) -> Path:
        p = self.root / name
        if p.is_dir():
            return p
        if name in ("", "default") and (self.root / "weights.gguf").exists():
            return self.root
        raise HTTPError(404, f"unknown model '{name}'")

    def register(self, name: str, model: LlamaModel, cfg: ModelConfig,
                 tokenizer: Tokenizer,
                 vlm: InternVLModel | None = None) -> ModelContext:
        """Serve an already built model under `name` (with vlm, the
        vision-language model whose language half `model` is). Over a
        rank group, `model` is built on this context's ranks
        (self.ranks.preset / load)."""
        if self.ranks is not None and getattr(model, "group",
                                              None) is not self.ranks:
            raise ValueError("a context over a rank group serves models "
                             "built on its own ranks")
        sched = BatchScheduler(model, cfg, self.hp, self.device)
        sched.start()
        ctx = ModelContext(name, sched, tokenizer, vlm=vlm)
        with self._lock:
            if vlm is not None:
                self._start_image_workers()
            return self._add(name, ctx)

    def get(self, name: str) -> ModelContext:
        name = name or self.default_model or "default"
        with self._lock:
            return self._get(name)

    @contextlib.contextmanager
    def use(self, name: str):
        """(ctx, done) for one request: the context of `name` (as get),
        in flight, so no eviction takes it, until done() is called (the
        reply is whole: a handler calls it before the reply's last bytes
        go out, so a client that has read its reply finds the context
        idle) or the with-block ends however it ends."""
        name = name or self.default_model or "default"
        with self._lock:
            ctx = self._get(name)
            ctx.in_flight += 1
        left = [False]

        def done() -> None:
            with self._lock:
                if not left[0]:
                    left[0] = True
                    ctx.in_flight -= 1

        try:
            yield ctx, done
        finally:
            done()

    def _add(self, name: str, ctx: ModelContext) -> ModelContext:
        """Register a new context as the most recently used, then evict
        to the budget."""
        self.models[name] = ctx
        self._touch(name)
        self._evict_to_budget()
        return ctx

    def _touch(self, name: str) -> None:
        if name in self._lru:
            self._lru.remove(name)
        self._lru.append(name)

    def _evict_to_budget(self) -> None:
        """Evict least recently used idle contexts past max_models: never
        a busy one (a request in flight, in its handler or in the
        scheduler) or the newest."""
        if self.max_models <= 0:
            return
        for name in list(self._lru):
            if len(self.models) <= self.max_models:
                return
            ctx = self.models.get(name)
            if ctx is None:
                self._lru.remove(name)
                continue
            sched = ctx.scheduler
            busy = (ctx.in_flight > 0 or sched.n_active > 0
                    or not sched.pending.empty() or bool(sched._waitq))
            if busy or name == self._lru[-1]:
                continue
            del self.models[name]
            self._lru.remove(name)
            self._release(ctx)
            log.info(f"evicted idle model context '{name}' (budget "
                     f"{self.max_models})")

    def _release(self, ctx: ModelContext) -> None:
        """Give an evicted context's device memory back: its scheduler's
        (scheduler.release), then over a rank group every rank's dropped
        shards and caches, then the allocator's cached blocks to CUDA."""
        ctx.scheduler.release()
        gc.collect()  # the graphs' and the snapshots' reference cycles
        if self.ranks is not None:
            self.ranks.release()
        elif self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _get(self, name: str) -> ModelContext:
        if name in self.models:
            self._touch(name)
            return self.models[name]
        if "+" in name:
            return self._speculative(name)
        d = self.resolve_dir(name)
        vlm = None
        if vlm_source(d) is not None:
            try:
                vlm = self._load_vlm(d)
            except (ValueError, KeyError, FileNotFoundError) as e:
                raise HTTPError(400, f"model '{name}': not a loadable "
                                     f"InternVL dir ({type(e).__name__}: "
                                     f"{e})") from e
            cfg, model = vlm.cfg, vlm.llm
            self._start_image_workers()
        else:
            cfg, model = self._load(d)
        sched = BatchScheduler(model, cfg, self.hp, self.device)
        sched.start()
        return self._add(name, ModelContext(name, sched,
                                            Tokenizer.from_model_dir(d),
                                            vlm=vlm))

    def _speculative(self, name: str) -> ModelContext:
        """"main+draft" / "main+self:N": a speculating scheduler over the
        weights of main's plain context."""
        main_name, draft_name = name.split("+", 1)
        draft_dir = None
        if not draft_name.startswith("self:"):
            draft_dir = self.resolve_dir(draft_name)
        base = self._get(main_name)
        model, cfg = base.scheduler.model, base.scheduler.cfg
        rank = int(self.hp.draft_head_rank)
        if self.pp > 1 and base.vlm is not None:
            raise HTTPError(400, f"model '{name}': VLM speculation does not "
                                 f"run under --pp")
        if self.pp > 1 and draft_dir is None:
            raise HTTPError(400, f"model '{name}': self-draft speculation "
                                 f"does not compose with --pp (layer "
                                 f"truncation breaks the stage layout); use "
                                 f"a separate draft model")
        if draft_dir is not None and gguf_architecture(draft_dir) == "eagle":
            if base.vlm is not None:
                raise HTTPError(400, f"model '{name}': VLM speculation takes "
                                     f"the batched chain or tree scheduler "
                                     f"only (no EAGLE head)")
            if self.ranks is not None:
                return self._start(name, base, eagle_head=self.ranks.eagle(
                    model, draft_dir, rank))
            # the head shares main's embedding and lm_head
            _, head = load_eagle_gguf(draft_dir, model, cfg.llm,
                                      device=self.device)
            if rank:
                head = with_lm_head_lr(head, make_draft_head(head.lm_head,
                                                             rank=rank))
            return self._start(name, base, eagle_head=head)
        if draft_dir is None:
            try:
                n = int(draft_name[5:])
                draft = (self_draft_model(model, n) if self.ranks is None
                         else self.ranks.self_draft(model, n))
            except ValueError as e:
                raise HTTPError(400, f"model '{name}': {e}") from e
        else:
            d_cfg, draft = self._load(draft_dir)
            # acceptance compares token ids: another vocab would accept
            # nonsense
            if d_cfg.llm.vocab_size != cfg.llm.vocab_size:
                raise HTTPError(400, f"draft vocab ({d_cfg.llm.vocab_size}) "
                                     f"!= target vocab "
                                     f"({cfg.llm.vocab_size})")
            # a VLM's draft takes the target's input rows
            if base.vlm is not None and d_cfg.llm.dim != cfg.llm.dim:
                raise HTTPError(400, f"model '{name}': a VLM's draft takes "
                                     f"its input rows: draft dim "
                                     f"{d_cfg.llm.dim} != target dim "
                                     f"{cfg.llm.dim}")
        if rank and self.ranks is not None:
            draft = self.ranks.with_draft_head(draft, rank)
        elif rank:
            draft = with_draft_head(draft, make_draft_head(draft.lm_head,
                                                           rank=rank))
        return self._start(name, base, draft=draft)

    def _start(self, name: str, base: ModelContext, **draft) -> ModelContext:
        """A speculating scheduler over base's weights with `draft` (a
        draft model or an EAGLE head), started and registered; a VLM's
        takes its input rows in both models."""
        try:
            sched = BatchScheduler(base.scheduler.model, base.scheduler.cfg,
                                   self.hp, self.device, **draft)
        except ValueError as e:  # a tree the verify cannot take
            raise HTTPError(400, f"model '{name}': {e}") from e
        sched.start()
        return self._add(name, ModelContext(name, sched, base.tokenizer,
                                            vlm=base.vlm))

    def _start_image_workers(self) -> None:
        """The image worker processes, started and ready with the first
        VLM context (under self._lock), so no request waits for them."""
        if self.image_workers is None:
            self.image_workers = ImageWorkers(IMAGE_WORKERS)

    def vlm_prompt(self, ctx: ModelContext, prompt_ids: list[int],
                   images: list[bytes]
                   ) -> tuple[list[int], torch.Tensor | None]:
        """A request's prompt ids and input rows: the images' tiles go at
        the prompt's image placeholder (else ahead of the prompt), decoded
        and preprocessed in the worker processes, encoded on the scheduler
        thread. No images (or a text model): the prompt as it is and no
        rows. An image the workers refuse is a 400; a worker that dies
        over one fails its request (a 500) and is replaced."""
        model = ctx.vlm
        if model is None or not images:
            return prompt_ids, None
        try:
            px = np.concatenate([self.image_workers.run(data, model.image_size)
                                 for data in images])
        except ValueError as e:
            raise HTTPError(400, f"image: {e}") from e
        ids = model.expand_image_tokens(list(prompt_ids), px.shape[0])
        # the decode feeds the last prompt token through the embedding
        # table: an image-context id there would condition the first token
        # on the placeholder's row
        if ids and ids[-1] == model.image_token_id:
            raise HTTPError(400, "multimodal prompt must end with text after "
                                 "the image (add a question or use a chat "
                                 "template)")

        def encode() -> torch.Tensor:
            dev = model.device
            return model.embed_multimodal(
                torch.tensor([ids], device=dev),
                torch.from_numpy(px).to(dev))[0].to(torch.bfloat16)

        return ids, ctx.scheduler.call(encode).result()

    def session_ids(self, body: dict) -> list[int]:
        """The token ids of the session a request names ("session"), to go
        before its own prompt; none without one; an unknown one is a
        404."""
        sid = body.get("session")
        if not sid:
            return []
        sess = self.sessions.get(sid)
        if sess is None:
            raise HTTPError(404, f"unknown session '{sid}'")
        return list(sess["ids"])

    def close(self) -> None:
        with self._lock:
            for m in self.models.values():
                m.scheduler.stop()
            self.models.clear()
            self._lru.clear()
            if self.image_workers is not None:
                self.image_workers.close()
                self.image_workers = None
            if self.ranks is not None:
                self.ranks.close()
                self.ranks = None


def _now_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def _stops_from_body(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return [s for s in stop if isinstance(s, str)]


def _logprobs_from_body(body: dict, chat: bool) -> int:
    """The two OpenAI shapes as a top-N count (0 = off). Completions:
    `logprobs: <int|null>`. Chat: `logprobs: <bool>` + `top_logprobs:
    <int>`. The chosen token's logprob is always reported when on."""
    lp = body.get("logprobs")
    if chat:
        if not lp:
            return 0
        return max(int(body.get("top_logprobs", 0)), 1)
    if lp is None or lp is False:
        return 0
    return max(int(lp), 1)


def _sampling_from_body(body: dict, chat: bool = False) -> dict:
    """OpenAI `frequency_penalty`/`presence_penalty` are the sampler's
    subtractive penalties; `repeat_penalty` is the multiplicative
    llama.cpp-style one."""
    seed = body.get("seed")
    return dict(
        temperature=float(body.get("temperature", 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        penalty_repeat=float(body.get("repeat_penalty", 1.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        max_tokens=int(body.get("max_tokens", body.get("n_predict", 128))),
        seed=None if seed is None else int(seed),
        logprobs=_logprobs_from_body(body, chat),
    )


def _check_spec_compat(ctx: ModelContext, sampling: dict) -> None:
    """Speculative ticks verify whole draft chains against the target's
    penalty-free distribution and record no logprobs: refuse requests
    that ask for them rather than answer them otherwise."""
    if ctx.scheduler.draft is None:
        return
    bad = []
    if sampling.get("logprobs", 0):
        bad.append("logprobs")
    if sampling.get("penalty_repeat", 1.0) != 1.0:
        bad.append("repeat_penalty")
    if sampling.get("penalty_freq", 0.0) != 0.0:
        bad.append("frequency_penalty")
    if sampling.get("penalty_present", 0.0) != 0.0:
        bad.append("presence_penalty")
    if bad:
        raise HTTPError(400, f"{', '.join(bad)} unsupported with speculative "
                             f"models ('main+draft'); retry without them or "
                             f"use the plain model name")


def _data_image(url) -> bytes:
    """A data: URI's bytes; anything else is a 400."""
    if not isinstance(url, str) or not url.startswith("data:"):
        raise HTTPError(400, "only data: image URIs supported")
    _, _, b64 = url.partition(",")
    try:
        return base64.b64decode(b64, validate=True)
    except binascii.Error as e:
        raise HTTPError(400, f"image: {e}") from e


def _split_multimodal(messages: list[dict]) -> tuple[list[dict], list]:
    """OpenAI messages -> (text-only messages, their images' bytes in
    order): text parts joined, image_url parts' data: URIs decoded."""
    images = []
    out = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            parts = []
            for p in content:
                if p.get("type") == "text":
                    parts.append(p.get("text", ""))
                elif p.get("type") == "image_url":
                    u = p.get("image_url")
                    u = u.get("url") if isinstance(u, dict) else u
                    images.append(_data_image(u))
            content = "".join(parts)
        out.append({"role": m.get("role", "user"), "content": content})
    return out, images


def _logprobs_payload(tok: Tokenizer, ids: list[int], req: Request,
                      chat: bool) -> dict:
    """The OpenAI logprobs object from the scheduler's per-token records."""
    n = min(len(ids), len(req.token_logprobs))
    if chat:
        return {"content": [{
            "token": tok.to_string([ids[i]]),
            "logprob": req.token_logprobs[i],
            "top_logprobs": [{"token": tok.to_string([t]), "logprob": lp}
                             for t, lp in req.top_logprobs[i]],
        } for i in range(n)]}
    toks, offs, off = [], [], 0
    for i in range(n):
        s = tok.to_string([ids[i]])
        toks.append(s)
        offs.append(off)
        off += len(s)
    return {
        "tokens": toks,
        "token_logprobs": req.token_logprobs[:n],
        "top_logprobs": [{tok.to_string([t]): lp
                          for t, lp in req.top_logprobs[i]}
                         for i in range(n)],
        "text_offset": offs,
    }


def generate(ctx: ModelContext, prompt_ids: list[int], sampling: dict,
             stop_ids: set[int], embeds: torch.Tensor | None = None):
    """Submit to the scheduler (with the prompt's input rows, if any);
    yield (token id, request) as they come. A consumer that stops early
    cancels the request."""
    q: queue.Queue = queue.Queue()
    req = Request(prompt_ids=list(prompt_ids), stop_ids=stop_ids,
                  sink=q.put, embeds=embeds, **sampling)
    ctx.scheduler.submit(req)
    try:
        while True:
            tok = q.get()
            if tok is None:
                return
            yield tok, req
    finally:
        if not req.finish_reason:
            req.cancelled = True


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_ctx: ServerContext  # set on the subclass make_server builds

    def log_message(self, fmt, *args):  # noqa: D401 — quiet access log
        log.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing ----------------------------------------------------------

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self._reply_whole()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: dict, status: int = 200) -> None:
        self._send(status, json.dumps(obj).encode(),
                   "application/json; charset=utf-8")

    def _text(self, text: str, status: int = 200) -> None:
        self._send(status, text.encode(), "text/plain; charset=utf-8")

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _event(self, obj) -> None:
        payload = obj if isinstance(obj, str) else json.dumps(obj)
        self._chunk(f"data: {payload}\n\n".encode())

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e

    def _reply_whole(self) -> None:
        """The request leaves "in flight" (ServerContext.use): its reply
        is whole, and what is left is writing it."""
        done, self._done = getattr(self, "_done", None), None
        if done is not None:
            done()

    def _dispatch(self, routes: dict) -> None:
        self._done = None
        fn = routes.get(self.path.split("?", 1)[0])
        try:
            if fn is None:
                raise HTTPError(404, "404: Not Found")
            fn()
        except HTTPError as e:
            self._text(e.text, e.status)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        except Exception as exc:  # noqa: BLE001 — answer, keep serving
            log.exception("request failed")
            self._json({"error": {"message": str(exc),
                                  "type": type(exc).__name__}}, 500)

    def do_GET(self) -> None:  # noqa: N802 — http.server's name
        self._dispatch({"/v1/models": self._models, "/health": self._health,
                        "/metrics": self._metrics,
                        "/v1/sessions": self._session_list})

    def do_POST(self) -> None:  # noqa: N802 — http.server's name
        routes = {r: self._completion for r in
                  ("/completion", "/completions", "/v1/completions")}
        routes.update({r: self._chat for r in
                       ("/chat/completions", "/v1/chat/completions")})
        routes["/v1/sessions"] = self._session_create
        self._dispatch(routes)

    def do_DELETE(self) -> None:  # noqa: N802 — http.server's name
        path = self.path.split("?", 1)[0]
        prefix = "/v1/sessions/"
        sid = path[len(prefix):] if path.startswith(prefix) else ""
        self._dispatch({path: lambda: self._session_delete(sid)}
                       if sid else {})

    # -- routes --------------------------------------------------------------

    def _completion(self) -> None:
        body = self._body()
        model_name = body.get("model", self.server_ctx.default_model)
        with self.server_ctx.use(model_name) as (ctx, self._done):
            self._complete(ctx, body, model_name)

    def _complete(self, ctx: ModelContext, body: dict,
                  model_name: str) -> None:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        prompt_ids = ctx.tokenize(
            prompt, parse_special=bool(body.get("parse_special", True)))
        prompt_ids = self.server_ctx.session_ids(body) + prompt_ids
        sampling = _sampling_from_body(body)
        _check_spec_compat(ctx, sampling)
        self._respond(ctx, prompt_ids, sampling, chat=False,
                      stream=bool(body.get("stream")),
                      model_name=model_name or ctx.name,
                      stop_strings=_stops_from_body(body))

    def _chat(self) -> None:
        body = self._body()
        model_name = body.get("model", self.server_ctx.default_model)
        with self.server_ctx.use(model_name) as (ctx, self._done):
            self._chat_reply(ctx, body, model_name)

    def _chat_reply(self, ctx: ModelContext, body: dict,
                    model_name: str) -> None:
        messages, images = _split_multimodal(body.get("messages", []))
        prompt = ctx.tokenizer.apply_chat_template(messages)
        prompt_ids = self.server_ctx.session_ids(body) + ctx.tokenize(prompt)
        sampling = _sampling_from_body(body, chat=True)
        _check_spec_compat(ctx, sampling)
        prompt_ids, embeds = self.server_ctx.vlm_prompt(ctx, prompt_ids,
                                                        images)
        self._respond(ctx, prompt_ids, sampling, chat=True,
                      stream=bool(body.get("stream")),
                      model_name=model_name or ctx.name,
                      stop_strings=_stops_from_body(body), embeds=embeds)

    def _models(self) -> None:
        ctx = self.server_ctx
        names = list(ctx.models) or [ctx.default_model or "default"]
        data = []
        for n in names:
            entry = {"id": n, "object": "model", "created": 0,
                     "owned_by": "powerserve_tpu"}
            m = ctx.models.get(n)
            if m is not None:
                llm = m.scheduler.cfg.llm
                entry["meta"] = {"n_ctx": m.scheduler.max_seq,
                                 "n_params_embd": llm.dim,
                                 "n_layers": llm.n_layers,
                                 "vocab_size": llm.vocab_size}
            data.append(entry)
        self._json({"object": "list", "data": data})

    def _health(self) -> None:
        self._json({"status": "ok",
                    "models_loaded": list(self.server_ctx.models)})

    def _metrics(self) -> None:
        lines = [f'powerserve_{k}{{model="{name}"}} {v}'
                 for name, m in list(self.server_ctx.models.items())
                 for k, v in m.scheduler.metrics().items()]
        self._text("\n".join(lines) + "\n")

    def _session_create(self) -> None:
        """POST /v1/sessions: prefill a prompt (or restore a file) and pin
        its snapshot; save it to save_path when given."""
        body = self._body()
        model_name = body.get("model", self.server_ctx.default_model)
        with self.server_ctx.use(model_name) as (ctx, self._done):
            self._session_prime(ctx, body, model_name)

    def _session_prime(self, ctx: ModelContext, body: dict,
                       model_name: str) -> None:
        sctx = self.server_ctx
        sched = ctx.scheduler
        if sched.prefix_cache is None:
            raise HTTPError(400, "prefix cache disabled (hp.prefix_cache = 0)")
        sid = body.get("id") or _now_id("sess")
        if body.get("load_path"):
            ids, groups = load_session_apart(body["load_path"])
            try:
                sched.insert_prefix(ids, groups, pin=True)
            except ValueError as e:
                raise HTTPError(400, f"session file: {e}") from e
        else:
            if body.get("messages"):
                messages, _ = _split_multimodal(body["messages"])
                prompt = ctx.tokenizer.apply_chat_template(
                    messages, add_assistant_prompt=False)
            else:
                prompt = body.get("prompt", "")
            if not prompt:
                raise HTTPError(400, "empty session prompt")
            ids = ctx.tokenize(prompt)
            if len(ids) >= sched.max_seq - 2:
                raise HTTPError(400, "session prompt exceeds n_ctx")
            sched.pin_prefix(ids)
            # the priming request: ids, then a token to feed the decode,
            # so the prefill of ids completes and is pinned; its one
            # greedy token is dropped
            sampling = dict(temperature=0.0, top_k=1, top_p=1.0,
                            penalty_repeat=1.0, max_tokens=1, seed=0,
                            logprobs=0)
            for _ in generate(ctx, ids + [ids[-1]], sampling, set()):
                pass
            if tuple(ids) not in sched.prefix_cache.entries:
                raise HTTPError(500, "session prefill did not produce a "
                                     "prefix")
        if body.get("save_path"):
            save_session(body["save_path"], ids, sched.export_prefix(ids))
        name = model_name or ctx.name
        sctx.sessions[sid] = {"id": sid, "model": name, "ids": ids,
                              "created": int(time.time())}
        self._json({"id": sid, "object": "session", "model": name,
                    "tokens": len(ids)})

    def _session_list(self) -> None:
        self._json({"object": "list", "data": [
            {"id": s["id"], "object": "session", "model": s["model"],
             "tokens": len(s["ids"]), "created": s["created"]}
            for s in list(self.server_ctx.sessions.values())]})

    def _session_delete(self, sid: str) -> None:
        sctx = self.server_ctx
        sess = sctx.sessions.pop(sid, None)
        if sess is None:
            raise HTTPError(404, f"unknown session '{sid}'")
        ctx = sctx.models.get(sess["model"])
        if ctx is not None:
            ctx.scheduler.drop_prefix(sess["ids"])
        self._json({"id": sid, "deleted": True})

    def _respond(self, ctx: ModelContext, prompt_ids: list[int],
                 sampling: dict, chat: bool, stream: bool, model_name: str,
                 stop_strings: list[str],
                 embeds: torch.Tensor | None = None) -> None:
        tok = ctx.tokenizer
        stop_ids = set(tok.stop_ids)
        rid = _now_id("chatcmpl" if chat else "cmpl")
        created = int(time.time())
        obj = ("chat.completion.chunk" if chat else "text_completion")
        want_logprobs = sampling.get("logprobs", 0) > 0
        matcher = StopMatcher(stop_strings)
        gen_ids: list[int] = []
        last_req = None

        def usage() -> dict:
            n = last_req.n_generated if last_req else 0
            return {"prompt_tokens": len(prompt_ids), "completion_tokens": n,
                    "total_tokens": len(prompt_ids) + n}

        def finish_reason() -> str:
            if matcher.stopped:
                return "stop"
            if last_req is not None and last_req.finish_reason:
                return last_req.finish_reason
            return "stop"

        if stream:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(piece: str) -> dict:
                return {"id": rid, "object": obj, "created": created,
                        "model": model_name,
                        "choices": [{"index": 0,
                                     **({"delta": {"content": piece}} if chat
                                        else {"text": piece}),
                                     "finish_reason": None}]}

            dec = IncrementalDecoder(tok)
            if chat:
                self._event({"id": rid, "object": obj, "created": created,
                             "model": model_name,
                             "choices": [{"index": 0,
                                          "delta": {"role": "assistant"},
                                          "finish_reason": None}]})
            for t, req in generate(ctx, prompt_ids, sampling, stop_ids,
                                   embeds):
                last_req = req
                gen_ids.append(t)
                piece = matcher.push(dec.push(t) if t not in stop_ids else "")
                if matcher.stopped:
                    req.cancelled = True
                if piece:
                    self._event(chunk(piece))
                if matcher.stopped:
                    break
            tail = ""
            if not matcher.stopped:
                tail = matcher.push(dec.flush())
                if matcher.stopped and last_req is not None:
                    last_req.cancelled = True
                else:
                    tail += matcher.flush()
            if tail:
                self._event(chunk(tail))
            self._reply_whole()
            choice = {"index": 0, **({"delta": {}} if chat else {"text": ""}),
                      "finish_reason": finish_reason()}
            if want_logprobs and last_req is not None:
                choice["logprobs"] = _logprobs_payload(tok, gen_ids, last_req,
                                                       chat)
            self._event({"id": rid, "object": obj, "created": created,
                         "model": model_name, "choices": [choice],
                         "usage": usage()})
            self._event("[DONE]")
            self._chunk(b"")
            return

        ids: list[int] = []
        for t, req in generate(ctx, prompt_ids, sampling, stop_ids, embeds):
            last_req = req
            gen_ids.append(t)
            if t not in stop_ids:
                ids.append(t)
            # decode-so-far check: cancel at the first stop-string match
            if stop_strings and any(s in tok.to_string(ids)
                                    for s in stop_strings):
                req.cancelled = True
                break
        text = tok.to_string(ids)
        if matcher.stops:
            out = matcher.push(text)
            if not matcher.stopped:
                out += matcher.flush()
            text = out
        lp_obj = (_logprobs_payload(tok, gen_ids, last_req, chat)
                  if want_logprobs and last_req is not None else None)
        lp = {"logprobs": lp_obj} if lp_obj else {}
        if chat:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      **lp, "finish_reason": finish_reason()}
        else:
            choice = {"index": 0, "text": text, **lp,
                      "finish_reason": finish_reason()}
        self._json({"id": rid, "object": "chat.completion" if chat
                    else "text_completion", "created": created,
                    "model": model_name, "choices": [choice],
                    "usage": usage()})


def make_server(ctx: ServerContext, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """An HTTP server for `ctx` bound to (host, port); port 0 picks a free
    one (server.server_address). Call serve_forever() to run it."""
    handler = type("Handler", (_Handler,), {"server_ctx": ctx})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch serve")
    ap.add_argument("-d", "--model-root", required=True,
                    help="dir of model dirs, one model dir, or a workspace")
    ap.add_argument("--model", default="default")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--paged-pages", type=int, default=0,
                    help="paged KV pool size in pages (0 = dense per-slot "
                         "KV); slots share the pool, with recompute "
                         "preemption when it runs dry")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page (with --paged-pages)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="chain draft length for \"main+draft\" models "
                         "(0 = hparams default)")
    ap.add_argument("--spec-horizon", type=int, default=0,
                    help="speculative steps per scheduler tick (0 = hparams "
                         "default)")
    ap.add_argument("--draft-head-rank", type=int, default=0,
                    help="factor the draft's lm_head to this rank at load "
                         "(0 = exact head)")
    ap.add_argument("--spec-tree", default="",
                    help="speculation-tree widths per depth for "
                         "\"main+draft\" models, e.g. 2,1,1 (default: a "
                         "chain of --spec-k)")
    ap.add_argument("--spec-wor", action="store_true",
                    help="tree speculation verifies children sampled "
                         "without replacement (recursive rejection) "
                         "instead of exact-match on greedy top-k")
    ap.add_argument("--max-models", type=int, default=0,
                    help="evict least-recently-used idle model contexts "
                         "past this count (0 = keep all)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: each model's heads, FFN "
                         "columns and vocab split over tp ranks "
                         "(parallel/tp.py)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel blocks of tp ranks: the slots (and "
                         "the paged pool's pages) split over dp")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' collectives: nccl (default on cuda, one "
                         "card a rank) or gloo (default on cpu; on cuda "
                         "ranks may share a card)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ranks: each dense cache's "
                         "positions split over sp ranks (with --tp, --dp)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: each model's layers and their "
                         "cache split over pp ranks (alone)")
    for flag in ("--gspmd", "--distributed"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    ap.add_argument("--weight-format", default="gguf", choices=WEIGHT_FORMATS,
                    help="gguf: the files' formats; w8: requantize the "
                         "projections to int8 with per-128 scales at load")
    args = ap.parse_args(argv)
    for flag, val in (("--gspmd", args.gspmd),
                      ("--distributed", args.distributed)):
        if val:
            ap.error(f"{flag} is not ported: ROADMAP §1 item 8b "
                     f"(parallelism) queues it")

    root = Path(args.model_root)
    if (root / "workspace.json").exists():
        ws = WorkspaceConfig.load(root)
        hp = ws.hyper_params
        root_dir, default = ws.main_model_dir.parent, ws.main_model_dir.name
    else:
        hp, root_dir, default = HyperParams(), root, args.model
    hp.max_slots = args.max_slots
    if args.paged_pages:
        hp.paged_pages = args.paged_pages
        hp.page_size = args.page_size
    if args.spec_k:
        hp.spec_k = args.spec_k
    if args.spec_horizon:
        hp.spec_horizon = args.spec_horizon
    if args.draft_head_rank:
        hp.draft_head_rank = args.draft_head_rank
    hp.spec_tree = args.spec_tree or hp.spec_tree
    hp.spec_wor = args.spec_wor or hp.spec_wor
    try:
        ctx = ServerContext(root_dir, default, hp, args.device, tp=args.tp,
                            dp=args.dp, sp=args.sp, pp=args.pp,
                            dist_backend=args.dist_backend,
                            max_models=args.max_models,
                            weight_format=args.weight_format)
    except ValueError as e:  # a mesh or a cache the port does not run
        ap.error(str(e))
    server = make_server(ctx, args.host, args.port)
    log.info(f"serving on http://{args.host}:{server.server_address[1]}")
    # SIGTERM ends the server as ^C does: the schedulers stop, and a rank
    # group's followers are told to stop before this process exits
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        ctx.close()
    return 0
