"""Pipeline parallelism: a model's layers over the stages of a mesh's pp
axis, the residual handed from stage to stage (the JAX parallel/pp.py).

Each stage is a rank (parallel/tp.py): stage s holds layers
[s * L / pp, (s + 1) * L / pp) and their cache (the dense cache's or the
paged pool's layer slabs: the page table, mask and pos are the same on
every stage, each stage maps the same pages onto its own slabs), and the
embedding, the final norm and the lm_head whole (JAX's pp_param_specs
replicates them too). Layer indices are a stage's own: its cache, its
prefix snapshots and its forward count from 0; the snapshots are put
together over the stages to be saved and cut again to be loaded
(parallel/tp.py ShardCache), so a session file is one device's.

A forward runs the stages one after another, each once:

  stage 0     x = embed(tokens) (or the request's input rows, embeds=)
  stage s     x = its layers over x (models/llama.py forward with
              embeds=x, logits_mode="none", return_final_hidden=True),
              sent to stage s + 1 (send / recv over the pp group)
  last stage  the head in the forward's logits_mode (argmax included),
              sent to stage 0, which returns it (with
              return_final_hidden, the final hidden too: an EAGLE head's
              features)

The residual crosses in the dtype the layer loop carries (bf16), so the
pipelined forward is bit-equal to one device's. Every stage applies the
same positions, active rows and tree options to its own layers' cache,
and advances its mask and pos once, so they agree on every stage. The
JAX forward runs every stage in every phase and gates the writes of the
phases that are not a stage's own; here a stage runs its layers once, in
its turn (a Known difference of function-equal schedules).

pp_prefill_microbatched is GPipe: the slots split into n_micro
microbatches of consecutive slots, and stage s runs microbatch m as soon
as stage s - 1 has handed it over, so at step t stage s runs microbatch
t - s (each stage's process loops over the microbatches; its recv waits
for the hand-off). Each microbatch writes its slots of the cache in
place (a view of those slots' rows). The JAX window kv_update is not
ported (ROADMAP.md §3).

Rank 0's entry points take a TPModel and its cache built on a pp mesh
(RankGroup.load / preset with pp=N):

    pp_forward(model, kv, tokens, positions, **forward keywords)
    pp_decode_scan(model, tokens, kv, n_steps)
    pp_prefill_microbatched(model, kv, tokens, positions, n_micro)
    pp_handoff_ms(model, shape)   the ms of one hop of a residual
"""

from __future__ import annotations

import time

import torch

from ..kv.cache import KVCache
from ..models.llama import LlamaModel

# the dtypes a stage hands on, by index in a hand-off's header
_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64,
           torch.bool, torch.float16, torch.int8, torch.uint8)
_MAX_DIMS = 6


def stage_span(n_layers: int, stage: int, pp: int) -> range:
    """The global indices of stage `stage`'s layers."""
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers do not split into pp={pp} "
                         f"stages")
    n = n_layers // pp
    return range(stage * n, (stage + 1) * n)


def shard_params_pp(model: LlamaModel, stage: int, pp: int) -> LlamaModel:
    """Stage `stage`'s part of `model` (the JAX pp_param_specs): its
    layers, and the embedding, final norm and lm_head (a factored head
    too) whole. The model itself is not changed; pp == 1 returns it."""
    if pp == 1:
        return model
    span = stage_span(len(model.layers), stage, pp)
    return LlamaModel(model.llm, model.embed,
                      [model.layers[i] for i in span], model.out_norm,
                      model.lm_head,
                      None if model.lm_head_lr is None
                      else tuple(model.lm_head_lr))


def send_tensors(comm, tensors: tuple, dst: int) -> None:
    """Tensors of any shape and dtype to group rank `dst` (recv_tensors):
    a count, a header of (dtype, rank, dims) rows, then each one's
    bytes."""
    dev = tensors[0].device
    head = torch.full((len(tensors), 2 + _MAX_DIMS), -1, dtype=torch.int64)
    for i, t in enumerate(tensors):
        head[i, 0] = _DTYPES.index(t.dtype)
        head[i, 1] = t.dim()
        head[i, 2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    comm.send(torch.tensor([len(tensors)], device=dev), dst)
    comm.send(head.to(dev), dst)
    for t in tensors:
        if t.numel():
            comm.send(t, dst)


def recv_tensors(comm, src: int, device: torch.device) -> tuple:
    """The tensors send_tensors sent from group rank `src`, on device."""
    n = comm.recv(torch.zeros(1, dtype=torch.int64, device=device), src)
    head = comm.recv(torch.zeros(int(n), 2 + _MAX_DIMS, dtype=torch.int64,
                                 device=device), src).tolist()
    out = []
    for row in head:
        t = torch.empty(row[2:2 + row[1]], dtype=_DTYPES[row[0]],
                        device=device)
        out.append(comm.recv(t, src) if t.numel() else t)
    return tuple(out)


def stage_forward(shard, kv, tokens: torch.Tensor, positions: torch.Tensor,
                  *, logits_mode: str = "last",
                  return_final_hidden: bool = False, **kw):
    """One stage's part of a pipelined forward (ShardModel.forward on a
    pp mesh): LlamaModel.forward's arguments; stage 0 returns its result,
    the other stages None."""
    if kw.get("return_hidden"):
        raise ValueError("return_hidden is not pipelined: every stage holds "
                         "a part of the layers")
    comm = shard.mesh.pp_comm
    s, last = comm.rank, comm.size - 1
    dev = tokens.device
    if s > 0:
        kw["embeds"] = recv_tensors(comm, s - 1, dev)[0]
    _, x = shard.model(kv.kv, tokens, positions, logits_mode="none",
                       return_final_hidden=True, **kw)
    if s < last:
        send_tensors(comm, (x,), s + 1)
        out = None
    else:
        logits = shard.model.logits(x, logits_mode)
        out = (logits, x) if return_final_hidden else (logits,)
        send_tensors(comm, out, 0)
    if s == 0:
        out = recv_tensors(comm, last, dev)
        return out if return_final_hidden else out[0]
    return None


class _SlotView(KVCache):
    """Slots [lo, hi) of a dense cache as a cache of their own: views of
    its slabs, mask and pos, so writes and advances land in place."""

    def __init__(self, kv: KVCache, lo: int, hi: int):
        self.storage = kv.storage
        self.k, self.k_scale, self.v, self.v_scale = (
            t[:, lo:hi] for t in (kv.k, kv.k_scale, kv.v, kv.v_scale))
        self.mask, self.pos = kv.mask[lo:hi], kv.pos[lo:hi]
        self._lo, self._all = lo, kv.k.shape[1]

    def _storage_rows(self, ok, slab, t):
        L, _, H, T = self.k_scale.shape
        h = torch.arange(H, device=slab.device)
        rows = ((slab + self._lo)[..., None] * H + h) * T + t[..., None]
        layer = torch.arange(L, device=slab.device)[:, None, None, None]
        rows = layer * (self._all * H * T) + rows[None]
        return torch.where(ok[None, ..., None], rows, L * self._all * H * T)


def stage_prefill_microbatched(shard, kv, tokens: torch.Tensor,
                               positions: torch.Tensor, n_micro: int) -> None:
    """One stage's part of the GPipe prefill: microbatch m (slots
    [m * S / n_micro, (m + 1) * S / n_micro)) through this stage's layers
    as soon as the previous stage hands it over."""
    S = tokens.shape[0]
    if S % n_micro:
        raise ValueError(f"{S} slots do not split into n_micro={n_micro}")
    if type(kv.kv) is not KVCache:
        raise ValueError("the microbatched prefill takes the dense cache")
    comm = shard.mesh.pp_comm
    s, last = comm.rank, comm.size - 1
    mb = S // n_micro
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        embeds = (recv_tensors(comm, s - 1, tokens.device)[0] if s > 0
                  else None)
        _, x = shard.model(_SlotView(kv.kv, rows.start, rows.stop),
                           tokens[rows], positions[rows], logits_mode="none",
                           return_final_hidden=True, embeds=embeds)
        if s < last:
            send_tensors(comm, (x,), s + 1)


def stage_handoff_ms(shard, shape: tuple, reps: int) -> float | None:
    """Stage 0's side of a timed hand-off: a bf16 residual of `shape` sent
    to stage 1 (send_tensors, as a forward sends it) and back, `reps`
    times; returns the host-clock ms of one hop on stage 0 (None on the
    other stages, which echo it)."""
    comm = shard.mesh.pp_comm
    dev = shard.model.out_norm.device
    x = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if comm.rank == 0:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            send_tensors(comm, (x,), 1)
            x = recv_tensors(comm, 1, dev)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / (2 * reps)
    if comm.rank == 1:
        for _ in range(reps):
            send_tensors(comm, recv_tensors(comm, 0, dev), 0)
    return None


def pp_handoff_ms(model, shape: tuple, reps: int = 20) -> float:
    """ms of one stage-to-stage hand-off of a bf16 residual of `shape`
    between stages 0 and 1 of a TPModel on a pp mesh (a round trip on
    rank 0's host clock, halved)."""
    return model._call("handoff_ms", tuple(shape), reps)


def pp_forward(model, kv, tokens: torch.Tensor, positions: torch.Tensor,
               **kw):
    """The pipelined forward (the JAX pp_forward): LlamaModel.forward's
    arguments and outputs, each stage running its layers once."""
    return model(kv, tokens, positions, **kw)


@torch.no_grad()
def pp_decode_scan(model, tokens: torch.Tensor, kv,
                   n_steps: int) -> torch.Tensor:
    """Greedy-decode n_steps tokens for every slot through the pipeline
    (the JAX pp_decode_scan; eager: its steps hold hand-offs). Returns
    [S, n_steps] int32."""
    out, tok = [], tokens
    for _ in range(n_steps):
        pos = kv.pos.to(torch.int64)[:, None]
        tok = model(kv, tok[:, None], pos, logits_mode="argmax")
        out.append(tok)
    return torch.stack(out, dim=1)


def pp_prefill_microbatched(model, kv, tokens: torch.Tensor,
                            positions: torch.Tensor, n_micro: int) -> None:
    """GPipe prefill of tokens/positions [S, C] in n_micro microbatches of
    consecutive slots (S must divide by n_micro): fills the cache as one
    forward of the whole batch would; the logits are not computed (the
    JAX pp_prefill_microbatched discards them)."""
    model._call("prefill_microbatched", kv, tokens, positions, n_micro)
