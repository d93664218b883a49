"""Tensor- and data-parallel serving over torch.distributed.

The JAX package runs the whole forward inside one shard_map over a
(dp, tp) mesh: each device runs the kernels on its local weight shards,
and the megatron collectives are explicit in the forward (tp_axis). The
port keeps that layout and those collectives (models/llama.py with a
TPComm), with one process a rank:

  - Rank 0 owns the host side: the scheduler (engine/scheduler.py), the
    server, requests, page grants, preemption, the prefix cache's keys
    and every sampled draw. Ranks 1..N-1 are followers.
  - Every operation on a model or a cache is broadcast by rank 0 and
    applied, in the same order, by every rank to its own shards: a
    forward, a cache's reset / rollback / tree KV ops / page grants /
    prefix snapshots, and the loads that build the shards. TPModel and
    TPCache on rank 0 are the model's and the caches' interfaces over
    those operations, so the scheduler and the speculative steps run
    as they are on one device.
  - dp splits the slots into blocks of tp ranks: every rank receives the
    whole batch, runs its block's rows, and the blocks' outputs are put
    together over the mesh (parallel/mesh.py). The paged pool's pages
    split the same way (PagePool(n_groups=dp); the global page ids of
    the table become each block's local ids, the JAX _remap_paged_dp).

An operation is a pickled header (the name, its arguments with each
tensor replaced by its place in a byte buffer, and the objects to drop)
and the tensors' bytes, broadcast as one uint8 buffer after its size.
Ticks that hold collectives run eagerly: gloo cannot be captured in a
CUDA graph. Rank 0's handles (TPModel, TPCache, a prefix-cache
snapshot's) drop the ranks' objects when they go, with rank 0's next
operation; RankGroup.release() then gives their device memory back (a
server's eviction). A session file's snapshot holds every head: it is
put together over tp to be saved, and each rank keeps its heads of a
loaded one.

The host re-layout is the JAX package's (tp.py:51-163): the fused QKV's
columns permuted so each rank's slice is [q_r | k_r | v_r], gate|up's
so it is [gate_r | up_r], and the row-parallel weights (wo, down, the
expert down slabs) repacked so the nibble pack group divides the local
K. shard_params_tp then takes param_specs' slices: QKV and gate|up
column-parallel with their biases, wo and down row-parallel, the expert
stacks [E, K, N] like the dense FFN (gate and up over N, down over K)
and, under expert parallelism (a mesh's ep axis), E / ep experts a rank,
the router, the norms and a factored draft head replicated, the
embedding and the lm_head over the vocab when it divides (else
replicated). A row-parallel weight whose local K is not a multiple of
the 32-wide scale blocks is refused ("K=... not row-shardable"), as JAX
refuses it.

Compositions over a rank group:
  - MoE models on every scheduler path, and with ep > 1 (reached through
    start_rank_group / ServerContext(ep=), as JAX reaches it by a mesh;
    no CLI flag) only the grouped route;
  - VLM requests: the tower runs on rank 0, a request's input rows go to
    every rank with the forward (TPModel.embed's lookup is the
    vocab-sharded one, run on every rank); followers load the text
    shards from weights.gguf or from an HF InternVL dir;
  - EAGLE heads (prepare_eagle_for_tp / eagle_param_specs): TPEagleHead
    runs eagle_forward on every rank's head shards and its cache shard;
    the head's heads must divide tp.

Pipeline and sequence parallelism ride the same operations on a mesh's
pp and sp axes (parallel/mesh.py):
  - pp (alone: check_mesh): each stage's ShardModel holds its layers
    (parallel/pp.py shard_params_pp) and a forward is the stage chain
    (pp.stage_forward: recv the residual, run the layers, send it on; the
    last stage runs the head and sends the result to rank 0); its caches
    hold the stage's layers, but an EAGLE head's (staged=False), which is
    whole on every stage, as the head is; a factored draft head factors
    the whole lm_head every stage holds;
  - sp: each rank's cache is a SeqShardCache, its slice of the positions
    (kv/cache.py), and the model's attention merges the slices' states
    over the sp group (LlamaModel.sp); a token tree's compaction moves an
    accepted entry between the ranks when its source and destination lie
    on different slices (SeqShardCache.gather_tokens), an EAGLE head's
    cache is whole on every sp rank (staged=False, as under pp), and the
    expert FFN, which acts on each token alone, runs as under tp (and
    ep); the paged pool is refused.
A snapshot under either is put together (over the stages' layers, over
the slices' positions) to be saved and cut again to be loaded
(ShardCache.export_prefix / import_prefix), so a session file is one
device's.

    python -m powerserve_tpu_torch serve -d <root> --tp 2 [--sp 2]
        [--dp 2] [--dist-backend nccl|gloo]
    python -m powerserve_tpu_torch serve -d <root> --pp 2

Not ported (ROADMAP §1 item 8b): several hosts, TP ticks replayed as CUDA
graphs.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import pickle
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import LLMConfig, ModelConfig
from ..core.logging import get_logger
from ..core.quant import QK, choose_pack_group
from ..kv.cache import KVCache, SeqShardCache
from ..kv.paged import PagedKVCache
from ..models.llama import LlamaLayer, LlamaModel, QEmbedding
from ..ops import cuda_lib
from ..ops.qmatmul import QLinear
from .distributed import (Followers, check_backend, init_distributed,
                          rank_device, watch_parent)
from .mesh import Mesh, TPComm

log = get_logger("tp")

# ---------------------------------------------------------------------------
# host-side re-layout (the JAX package's tp.py:51-163)
# ---------------------------------------------------------------------------


def _unpack_nib(q: torch.Tensor, group: int) -> torch.Tensor:
    """uint8 [.., K/2, N] packed in groups of `group` rows -> the raw
    nibbles uint8 [.., K, N]."""
    half = group // 2
    *lead, kh, n = q.shape
    pg = q.reshape(*lead, kh // half, half, n)
    return torch.cat([pg & 0xF, pg >> 4], dim=-2).reshape(*lead, kh * 2, n)


def _pack_nib(u: torch.Tensor, group: int) -> torch.Tensor:
    """The inverse: raw nibbles uint8 [.., K, N] -> packed [.., K/2, N]."""
    half = group // 2
    *lead, k, n = u.shape
    ug = u.reshape(*lead, k // group, group, n)
    return (ug[..., :half, :] | (ug[..., half:, :] << 4)).reshape(
        *lead, k // 2, n)


def _qlinear_like(lin: QLinear, q, scales, bias, **meta) -> QLinear:
    kw = dict(packed=lin.packed, unsigned=lin.unsigned,
              in_features=lin.in_features, out_features=lin.out_features,
              pack_group=lin.pack_group, scale_group=lin.scale_group)
    kw.update(meta)
    return QLinear(q, scales, bias, **kw)


def _permute_cols(lin: QLinear, perm: np.ndarray) -> QLinear:
    idx = torch.as_tensor(perm, device=lin.q.device)
    def take(t):
        return None if t is None else t.index_select(-1, idx)

    return _qlinear_like(lin, take(lin.q), take(lin.scales), take(lin.bias))


def _qkv_perm(H: int, Hkv: int, D: int, tp: int) -> np.ndarray:
    """Column order so rank s holds [q_s | k_s | v_s] contiguously."""
    q_off, k_off, v_off = 0, H * D, (H + Hkv) * D
    hq, hkv = H // tp * D, Hkv // tp * D
    parts = []
    for s in range(tp):
        parts.append(np.arange(q_off + s * hq, q_off + (s + 1) * hq))
        parts.append(np.arange(k_off + s * hkv, k_off + (s + 1) * hkv))
        parts.append(np.arange(v_off + s * hkv, v_off + (s + 1) * hkv))
    return np.concatenate(parts)


def _gu_perm(F: int, tp: int) -> np.ndarray:
    """Column order so rank s holds [gate_s | up_s] contiguously."""
    f = F // tp
    parts = []
    for s in range(tp):
        parts.append(np.arange(s * f, (s + 1) * f))
        parts.append(np.arange(F + s * f, F + (s + 1) * f))
    return np.concatenate(parts)


def _repack_rows(lin: QLinear | None, tp: int) -> QLinear | None:
    """A row-parallel QLinear made splittable into tp K-shards: the scale
    blocks and the nibble pack group must divide the local K."""
    if lin is None:
        return None
    k = lin.in_features
    if k % tp or (k // tp) % lin.scale_group:
        raise ValueError(f"K={k} not row-shardable over tp={tp}")
    if not lin.packed or (k // tp) % lin.pack_group == 0:
        return lin
    group = choose_pack_group(k // tp)
    return _qlinear_like(lin, _pack_nib(_unpack_nib(lin.q, lin.pack_group),
                                        group),
                         lin.scales, lin.bias, pack_group=group)


_LAYER_FIELDS = ("wo", "w_down", "wqkv", "bqkv", "wq", "wk", "wv", "bq", "bk",
                 "bv", "wgu", "w_gate", "w_up", "q_norm", "k_norm", "router",
                 "w_gate_exps", "w_up_exps", "w_down_exps")


def _layer_like(lw: LlamaLayer, **changes) -> LlamaLayer:
    kw = {f: getattr(lw, f) for f in _LAYER_FIELDS}
    kw.update(changes)
    return LlamaLayer(lw.attn_norm, lw.ffn_norm, **kw)


def _model_like(model: LlamaModel, **changes) -> LlamaModel:
    kw = dict(llm=model.llm, embed=model.embed, layers=list(model.layers),
              out_norm=model.out_norm, lm_head=model.lm_head,
              lm_head_lr=(None if model.lm_head_lr is None
                          else tuple(model.lm_head_lr)))
    kw.update(changes)
    return LlamaModel(**kw)


def _prepare_layer(lw: LlamaLayer, H: int, Hkv: int, D: int,
                   tp: int) -> LlamaLayer:
    """One layer's host re-layout (a target's or an EAGLE head's: the
    JAX _fix_layer_for_tp)."""
    ch = dict(wo=_repack_rows(lw.wo, tp), w_down=_repack_rows(lw.w_down, tp),
              w_down_exps=_repack_rows(lw.w_down_exps, tp))
    if lw.wqkv is not None:
        perm = _qkv_perm(H, Hkv, D, tp)
        ch["wqkv"] = _permute_cols(lw.wqkv, perm)
        if lw.bqkv is not None:
            ch["bqkv"] = lw.bqkv.index_select(
                -1, torch.as_tensor(perm, device=lw.bqkv.device))
    if lw.wgu is not None:
        ch["wgu"] = _permute_cols(lw.wgu,
                                  _gu_perm(lw.wgu.out_features // 2, tp))
    return _layer_like(lw, **ch)


def prepare_params_for_tp(model: LlamaModel, tp: int) -> LlamaModel:
    """The host re-layout before sharding: the fused QKV's and gate|up's
    columns permuted per rank, wo, down and the expert down slabs
    repacked to a pack group that divides the local K. The model itself
    is not changed; tp == 1 returns it."""
    if tp == 1:
        return model
    llm = model.llm
    H, Hkv, D = llm.n_heads, llm.n_kv_heads, llm.head_size
    if H % tp or Hkv % tp:
        raise ValueError(f"heads {H}/{Hkv} not divisible by tp={tp}")
    return _model_like(model, layers=[_prepare_layer(lw, H, Hkv, D, tp)
                                      for lw in model.layers])


def local_llm_config(llm: LLMConfig, tp: int) -> LLMConfig:
    """One rank's head counts (vocab and dim stay global: the residual
    is replicated, and a vocab-sharded table is told by its rows)."""
    if tp == 1:
        return llm
    if llm.n_heads % tp or llm.n_kv_heads % tp:
        raise ValueError(f"heads not divisible by tp={tp}")
    return dataclasses.replace(
        llm, n_heads=llm.n_heads // tp, n_kv_heads=llm.n_kv_heads // tp,
        kv_dim=llm.n_kv_heads // tp * llm.head_size)


def _span(n: int, rank: int, tp: int) -> slice:
    if n % tp:
        raise ValueError(f"{n} does not split over tp={tp}")
    return slice(rank * (n // tp), (rank + 1) * (n // tp))


def _cols(lin: QLinear | None, rank: int, tp: int) -> QLinear | None:
    """Column-parallel: this rank's output columns."""
    if lin is None:
        return None
    sl = _span(lin.out_features, rank, tp)

    def cut(t):
        return None if t is None else t[..., sl].contiguous()

    return _qlinear_like(lin, cut(lin.q), cut(lin.scales), cut(lin.bias),
                         out_features=sl.stop - sl.start)


def _rows(lin: QLinear | None, rank: int, tp: int) -> QLinear | None:
    """Row-parallel: this rank's K rows (of q, the scales and the
    minimums), the pack group already dividing the local K."""
    if lin is None:
        return None
    k = lin.in_features // tp

    def cut(t, unit):
        if t is None:
            return None
        sl = _span(t.shape[-2], rank, tp)
        assert sl.stop - sl.start == k // unit
        return t[..., sl, :].contiguous()

    return _qlinear_like(lin, cut(lin.q, 2 if lin.packed else 1),
                         cut(lin.scales, lin.scale_group), cut(lin.bias, QK),
                         in_features=k)


def _vec(t: torch.Tensor | None, rank: int, tp: int):
    return None if t is None else t[..., _span(t.shape[-1], rank,
                                               tp)].contiguous()


def _experts(lin: QLinear | None, ep_rank: int, ep: int) -> QLinear | None:
    """Expert parallelism: this rank's E / ep slabs of an expert stack."""
    if lin is None or ep == 1:
        return lin
    sl = _span(lin.n_slabs, ep_rank, ep)

    def cut(t):
        return None if t is None else t[sl].contiguous()

    return _qlinear_like(lin, cut(lin.q), cut(lin.scales), cut(lin.bias))


def _shard_layer(lw: LlamaLayer, rank: int, tp: int, ep_rank: int = 0,
                 ep: int = 1) -> LlamaLayer:
    """Rank (tp rank, ep rank)'s shard of a prepared layer (the JAX
    _layer_specs' slices)."""
    return _layer_like(
        lw, wqkv=_cols(lw.wqkv, rank, tp), bqkv=_vec(lw.bqkv, rank, tp),
        wq=_cols(lw.wq, rank, tp), wk=_cols(lw.wk, rank, tp),
        wv=_cols(lw.wv, rank, tp), bq=_vec(lw.bq, rank, tp),
        bk=_vec(lw.bk, rank, tp), bv=_vec(lw.bv, rank, tp),
        wgu=_cols(lw.wgu, rank, tp), w_gate=_cols(lw.w_gate, rank, tp),
        w_up=_cols(lw.w_up, rank, tp), wo=_rows(lw.wo, rank, tp),
        w_down=_rows(lw.w_down, rank, tp),
        w_gate_exps=_cols(_experts(lw.w_gate_exps, ep_rank, ep), rank, tp),
        w_up_exps=_cols(_experts(lw.w_up_exps, ep_rank, ep), rank, tp),
        w_down_exps=_rows(_experts(lw.w_down_exps, ep_rank, ep), rank, tp))


def _shard_embed(emb: QEmbedding, rank: int, tp: int) -> QEmbedding:
    if emb.q.shape[0] % tp:
        return emb
    sl = _span(emb.q.shape[0], rank, tp)
    return QEmbedding(*(None if t is None else t[sl].contiguous()
                        for t in (emb.q, emb.scales, emb.bias)))


def _shard_head(head: QLinear, rank: int, tp: int) -> QLinear:
    return _cols(head, rank, tp) if head.out_features % tp == 0 else head


def check_mesh(tp: int, dp: int, ep: int, sp: int, pp: int) -> None:
    """Refuse the meshes the port does not run: pp beside any other axis
    (JAX's pp mesh is {"pp": N})."""
    if pp > 1 and (tp, dp, ep, sp) != (1, 1, 1, 1):
        raise ValueError(f"pp runs alone: pp={pp} with tp={tp}, dp={dp}, "
                         f"ep={ep}, sp={sp}")


def _check_model(cfg: ModelConfig, pp: int) -> None:
    """Refuse a depth pp does not divide."""
    if cfg.llm.n_layers % pp:
        raise ValueError(f"{cfg.llm.n_layers} layers do not split into "
                         f"pp={pp} stages")


def shard_params_tp(model: LlamaModel, rank: int, tp: int,
                    ep_rank: int = 0, ep: int = 1) -> LlamaModel:
    """Rank `rank`'s shards of `model` (after prepare_params_for_tp), with
    the local head counts; under expert parallelism (ep > 1) ep rank
    `ep_rank`'s E / ep experts of every MoE layer: the JAX package's
    param_specs, taken on the host. The returned model has no TPComm yet
    (LlamaModel.tp, .ep)."""
    n_exp = {lw.w_gate_exps.n_slabs for lw in model.layers
             if lw.router is not None}
    if ep > 1 and (not n_exp or any(e % ep for e in n_exp)):
        raise ValueError(f"expert parallelism over ep={ep} takes an MoE "
                         f"model whose experts split ({sorted(n_exp)})")
    if tp == 1 and ep == 1:
        return model
    model = prepare_params_for_tp(model, tp)
    layers = [_shard_layer(lw, rank, tp, ep_rank, ep) for lw in model.layers]
    return _model_like(model, llm=local_llm_config(model.llm, tp),
                       embed=_shard_embed(model.embed, rank, tp),
                       layers=layers,
                       lm_head=_shard_head(model.lm_head, rank, tp))


def prepare_eagle_for_tp(head, tp: int):
    """An EAGLE head's host re-layout before sharding (JAX
    prepare_eagle_for_tp): each layer as a target layer's."""
    if tp == 1:
        return head
    llm = head.llm
    H, Hkv, D = llm.n_heads, llm.n_kv_heads, llm.head_size
    if H % tp or Hkv % tp:
        raise ValueError(f"eagle heads {H}/{Hkv} not divisible by tp={tp}")
    return _eagle_like(head, layers=[_prepare_layer(lw, H, Hkv, D, tp)
                                     for lw in head.layers])


def _eagle_like(head, **changes):
    from ..speculative.eagle import EagleHead

    kw = dict(llm=head.llm, fc=head.fc, fc_bias=head.fc_bias,
              layers=list(head.layers), embed=head.embed,
              lm_head=head.lm_head, out_norm=head.out_norm,
              input_norm=head.input_norm,
              lm_head_lr=(None if head.lm_head_lr is None
                          else tuple(head.lm_head_lr)))
    kw.update(changes)
    return EagleHead(**kw)


def shard_eagle_tp(head, rank: int, tp: int, target: LlamaModel):
    """Rank `rank`'s shards of an EAGLE head (JAX eagle_param_specs): its
    layers as a target layer's, the fc, its bias, the norms and a
    factored head replicated; the embedding and lm_head the target
    shard's own objects where the head shares the target's (else its
    own, over the vocab when it divides)."""
    if tp == 1:
        return head
    prep = prepare_eagle_for_tp(head, tp)
    embed = (target.embed if head.embed is target.embed
             else _shard_embed(head.embed, rank, tp))
    lm_head = (target.lm_head if head.lm_head is target.lm_head
               else _shard_head(head.lm_head, rank, tp))
    return _eagle_like(prep, llm=local_llm_config(head.llm, tp),
                       layers=[_shard_layer(lw, rank, tp)
                               for lw in prep.layers],
                       embed=embed, lm_head=lm_head)


def _gather_cols(lin: QLinear, comm: TPComm) -> QLinear:
    """A column-parallel QLinear whole again, on every rank of comm."""
    def whole(t):
        if t is None:
            return None
        n = t.shape[-1]
        full = t.new_zeros(*t.shape[:-1], n * comm.size)
        full[..., comm.rank * n:(comm.rank + 1) * n] = t
        return comm.all_reduce(full)

    return _qlinear_like(lin, whole(lin.q), whole(lin.scales),
                         whole(lin.bias),
                         out_features=lin.out_features * comm.size)


def _factored(head: QLinear, base: "ShardModel", rank: int) -> tuple:
    """A factored draft head (U, V) of a rank's lm_head (gathered whole
    when it is a vocab shard), the same on every rank (replicated)."""
    from ..speculative.draft_head import make_draft_head

    if head.out_features != base.cfg.llm.vocab_size:
        head = _gather_cols(head, base.mesh.comm)
    return make_draft_head(head, rank=rank)


# ---------------------------------------------------------------------------
# the shards on each rank, and the operations on them
# ---------------------------------------------------------------------------

# forward arguments with a slot axis first (a dp block takes its rows)
_SLOT_ARGS = ("active", "cache_positions", "key_positions", "attn_mask",
              "embeds")


def _block_args(mesh: Mesh, S: int, tensors: tuple, kw: dict):
    """A dp block's rows of a batch's slot-first arguments."""
    if mesh.dp == 1:
        return tensors, kw
    lo, hi = mesh.block(S)
    return (tuple(t[lo:hi] for t in tensors),
            {k: (v[lo:hi] if k in _SLOT_ARGS and v is not None else v)
             for k, v in kw.items()})


def _assemble_out(mesh: Mesh, out, S: int):
    """A forward's output (a tensor, or a tuple of them) with every dp
    block's rows."""
    if isinstance(out, tuple):
        return tuple(mesh.assemble(o, S) for o in out)
    return mesh.assemble(out, S)


class ShardModel:
    """One rank's shards of a model on a mesh; `cfg` is the global
    config, `model.llm` the local one."""

    def __init__(self, mesh: Mesh, model: LlamaModel, cfg: ModelConfig):
        self.mesh, self.model, self.cfg = mesh, model, cfg
        model.tp = mesh.comm
        model.ep = mesh.ep_comm
        model.sp = mesh.sp_comm

    def forward(self, kv: "ShardCache", tokens: torch.Tensor,
                positions: torch.Tensor, **kw) -> torch.Tensor:
        """The whole batch's forward: this block's rows through the local
        shards, the blocks' outputs put together (with
        return_final_hidden, the logits and the final hidden); on a pp
        mesh this stage's part of the pipelined forward (parallel/pp.py)."""
        if self.mesh.pp > 1:
            from .pp import stage_forward

            return stage_forward(self, kv, tokens, positions, **kw)
        S = tokens.shape[0]
        (tokens, positions), kw = _block_args(self.mesh, S,
                                              (tokens, positions), kw)
        return _assemble_out(self.mesh, self.model(kv.kv, tokens, positions,
                                                   **kw), S)

    def prefill_microbatched(self, kv: "ShardCache", tokens: torch.Tensor,
                             positions: torch.Tensor, n_micro: int) -> None:
        """This stage's part of the GPipe prefill (parallel/pp.py)."""
        from .pp import stage_prefill_microbatched

        stage_prefill_microbatched(self, kv, tokens, positions, n_micro)

    def handoff_ms(self, shape: tuple, reps: int) -> float | None:
        """A timed stage-to-stage hand-off (parallel/pp.py)."""
        from .pp import stage_handoff_ms

        return stage_handoff_ms(self, shape, reps)

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' input rows f32 (the vocab-sharded lookup), on every
        rank (the rows of a VLM request's overlay)."""
        return self.model.embed_tokens(tokens)

    def replica_eagle(self) -> "ShardEagle":
        """The exact-replica head (speculative/eagle.py replica_head) of
        this 1-layer model's shards."""
        from ..speculative.eagle import replica_head

        return ShardEagle(self.mesh, replica_head(self.model))


class ShardEagle:
    """One rank's shards of an EAGLE head (speculative/eagle.py) on its
    target's mesh."""

    def __init__(self, mesh: Mesh, head):
        self.mesh, self.head = mesh, head
        head.tp = mesh.comm

    def forward(self, kv: "ShardCache", tokens: torch.Tensor,
                features: torch.Tensor, positions: torch.Tensor, **kw):
        from ..speculative.eagle import eagle_forward

        S = tokens.shape[0]
        (tokens, features, positions), kw = _block_args(
            self.mesh, S, (tokens, features, positions), kw)
        return _assemble_out(self.mesh, eagle_forward(
            self.head, kv.kv, tokens, features, positions, **kw), S)


def _put_together(t: torch.Tensor, comm: TPComm | None, axis: int,
                  offset: int, total: int) -> torch.Tensor:
    """t, this rank's [offset, offset + len) of `axis`, put together with
    the other ranks' of comm into all `total`: an all_reduce of
    zero-filled copies (int8 and bool widened to int32, so a value plus
    zeros is exact), in t's dtype. comm None: t."""
    if comm is None:
        return t
    wide = t.to(torch.int32) if t.dtype in (torch.int8, torch.bool) else t
    shape = list(wide.shape)
    shape[axis] = total
    full = wide.new_zeros(shape)
    full.narrow(axis, offset, wide.shape[axis]).copy_(wide)
    return comm.all_reduce(full).to(t.dtype)


def _all_heads(t: torch.Tensor, m: Mesh, axis: int) -> torch.Tensor:
    """t with this rank's heads on `axis` put together with the other tp
    ranks' in the global head order."""
    h = t.shape[axis]
    return _put_together(t, m.comm, axis, m.tp_rank * h, h * m.tp)


def _all_layers(t: torch.Tensor, m: Mesh) -> torch.Tensor:
    """t [L_stage, ...] with every stage's layers, in order (axis 0)."""
    n = t.shape[0]
    return _put_together(t, m.pp_comm, 0, m.pp_rank * n, n * m.pp)


class ShardCache:
    """One rank's cache: its kv heads of its dp block's slots (paged: of
    its block's pages), under sp its slice of the positions (a
    SeqShardCache), under pp its stage's layers (staged=False: every
    layer and position, a replicated EAGLE head's cache). The methods
    take the whole batch's arguments."""

    def __init__(self, mesh: Mesh, kv: KVCache, n_slots: int,
                 n_pages: int = 0, staged: bool = True):
        self.mesh, self.kv = mesh, kv
        self.lo, self.hi = mesh.block(n_slots)
        self.n_slots = n_slots
        # the layers split over the pp stages
        self.staged = staged and mesh.pp > 1
        if n_pages:
            self.p_lo, self.p_hi = mesh.block(n_pages)

    def _layers(self, t: torch.Tensor) -> torch.Tensor:
        """t [L_stage, ...] with every layer (over pp when staged)."""
        return _all_layers(t, self.mesh) if self.staged else t

    def _times(self, t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
        """t, this rank's part of n positions on `axis` (under sp its
        slice, from its t0), with every rank's."""
        if not isinstance(self.kv, SeqShardCache):
            return t
        return _put_together(t, self.mesh.sp_comm, axis, min(self.kv.t0, n),
                             n)

    def _rows(self, x):
        if self.mesh.dp == 1 or not torch.is_tensor(x) or x.dim() == 0:
            return x
        return x[self.lo:self.hi]

    def _mine(self, slot: int) -> bool:
        return self.lo <= int(slot) < self.hi

    def pos(self) -> torch.Tensor:
        return self.mesh.assemble(self.kv.pos, self.n_slots)

    def mask(self) -> torch.Tensor:
        mask = self._times(self.kv.mask, 1, self.kv.max_seq)
        return self.mesh.assemble(mask, self.n_slots)

    def reset_slot(self, slot: int) -> None:
        if self._mine(slot):
            self.kv.reset_slot(int(slot) - self.lo)

    def rollback(self, n, active=None) -> None:
        self.kv.rollback(self._rows(n), self._rows(active))

    def commit_tokens(self, slot_indices, src_positions, n_accept) -> None:
        self.kv.commit_tokens(None, self._rows(src_positions),
                              self._rows(n_accept))

    def save_slot_prefix(self, slot: int, n: int) -> dict:
        """This rank's heads of the slot's first n tokens; under dp the
        owning block's snapshot is copied to every block, so a later
        request restores it into a slot of any block."""
        owner = int(slot) // (self.hi - self.lo)
        if self.mesh.dp_rank == owner:
            snap = self.kv.save_slot_prefix(int(slot) - self.lo, n)
        else:
            L, _, H, _, D = self.kv.k.shape
            dev = self.kv.device
            m = self.kv.n_local(n)
            snap = {"n": n,
                    "k": torch.zeros(L, H, m, D, dtype=torch.int8, device=dev),
                    "v": torch.zeros(L, H, m, D, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(L, H, m, device=dev),
                    "v_scale": torch.zeros(L, H, m, device=dev)}
        if self.mesh.dp > 1:
            for name in ("k", "v", "k_scale", "v_scale"):
                self.mesh.peers.broadcast(snap[name], owner)
        return snap

    def restore_slot_prefix(self, slot: int, saved: dict) -> None:
        if self._mine(slot):
            self.kv.restore_slot_prefix(int(slot) - self.lo, saved["handle"])

    def import_prefix(self, host: dict) -> dict:
        """This rank's part of a whole snapshot (every layer, head and
        position, on the cpu), on its device: its heads, under pp its
        stage's layers, under sp its slice of the positions. Every dp
        block keeps it, as save_slot_prefix leaves a snapshot in every
        block."""
        m, n = self.mesh, int(host["n"])
        h = self.kv.n_kv_heads
        heads = slice(m.tp_rank * h, (m.tp_rank + 1) * h)
        L = self.kv.n_layers
        layers = (slice(m.pp_rank * L, (m.pp_rank + 1) * L) if self.staged
                  else slice(None))
        t0 = getattr(self.kv, "t0", 0)
        times = slice(t0, t0 + self.kv.n_local(n))
        out = {"n": n}
        for name in ("k", "v", "k_scale", "v_scale"):
            out[name] = (torch.as_tensor(host[name])[layers, heads, times]
                         .to(self.kv.device).contiguous())
        return out

    def export_prefix(self, saved: dict) -> dict:
        """A snapshot's every head (over tp, in the global head order),
        every layer (over pp) and every position (over sp), on every rank
        of the mesh (each dp block holds the whole snapshot)."""
        snap = saved["handle"]
        n = snap["n"]
        return {"n": n, **{  # [L, h, n(, D)] -> every layer, head, position
            name: self._layers(self._times(_all_heads(snap[name], self.mesh,
                                                      1), 2, n))
            for name in ("k", "v", "k_scale", "v_scale")}}

    def gathered(self) -> dict:
        """The whole cache on every rank of the mesh: k, v, k_scale,
        v_scale with every head (put together over tp), every slot or
        page (over dp), every position (over sp) and every layer (over
        pp), and pos and mask (checks and tests)."""
        out = {"pos": self.pos(), "mask": self.mask()}
        m = self.mesh
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(self.kv, name)  # [L, slots or pages, H, T(, D)]
            t = self._layers(self._times(t, 3, self.kv.max_seq))
            full = _all_heads(t, m, 2).movedim(1, 0).contiguous()
            if full.dtype == torch.int8:
                full = full.to(torch.int32)
            full = m.assemble(full, full.shape[0] * m.dp)
            out[name] = full.movedim(0, 1).to(t.dtype)
        return out

    def assign_pages(self, table: np.ndarray) -> None:
        """The global page table's rows of this block, with the global
        page ids of the block's partition made local (any other id, and
        the unallocated sentinel, the local sentinel)."""
        t = np.asarray(table, np.int64)[self.lo:self.hi]
        n = self.p_hi - self.p_lo
        mine = (t >= self.p_lo) & (t < self.p_hi)
        self.kv.assign_pages(np.where(mine, t - self.p_lo, n))


def _model_from_gguf(group, path, mxu=False):
    from ..models.loader import load_gguf_model

    return load_gguf_model(path, device=group.device, mxu=mxu)


def _model_from_preset(group, preset, quant, seed, layers=None):
    from ..tools.bench_params import make_device_params

    return make_device_params(preset, quant, seed=seed, device=group.device,
                              layers=layers)


def _model_from_hf_internvl(group, path, mxu=False):
    """An HF InternVL checkpoint dir's text model (models/internvl.py
    hf_text_reader: Q8_0 in memory, as JAX's internvl_from_hf)."""
    from ..models.internvl import hf_text_reader
    from ..models.loader import load_gguf_model

    reader, _, _ = hf_text_reader(path)
    return load_gguf_model(reader, device=group.device, mxu=mxu)


_LOADERS = {"gguf": _model_from_gguf, "preset": _model_from_preset,
            "hf_internvl": _model_from_hf_internvl}


class RankGroup:
    """The ranks of one process group, from the view of one rank. Rank 0
    runs operations (run); the others apply them (follow). Objects are
    kept by id on every rank that holds a part of them."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device, followers: Followers | None = None):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = device
        self.followers = followers
        # the device an operation's bytes travel on
        self.wire = device if backend == "nccl" else torch.device("cpu")
        self.objs: dict[int, object] = {}
        self.meshes: dict[tuple, Mesh] = {}
        self._ids = itertools.count(1)
        self._drops: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.closed = False
        # rank 0's thread count before the group took its share of cores
        self.threads_before = 0

    # -- the wire ----------------------------------------------------------

    def _encode(self, obj, tensors: list):
        if torch.is_tensor(obj):
            tensors.append(obj)
            return _T(len(tensors) - 1, obj.device.type == "cpu")
        if isinstance(obj, _Remote):
            return _Ref(obj.oid)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._encode(o, tensors) for o in obj)
        if isinstance(obj, dict):
            return {k: self._encode(v, tensors) for k, v in obj.items()}
        return obj

    def _decode(self, obj, tensors: list):
        if isinstance(obj, _T):
            t = tensors[obj.i]
            return t.cpu() if obj.cpu else t.to(self.device)
        if isinstance(obj, _Ref):
            return self.objs.get(obj.oid)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._decode(o, tensors) for o in obj)
        if isinstance(obj, dict):
            return {k: self._decode(v, tensors) for k, v in obj.items()}
        return obj

    @staticmethod
    def _aligned(n: int) -> int:
        return -(-n // 8) * 8

    def _send(self, msg, tensors: list) -> None:
        metas, parts, off = [], [], 0
        for t in tensors:
            b = t.detach().contiguous().reshape(-1).view(torch.uint8)
            metas.append((t.dtype, tuple(t.shape), off, b.numel()))
            parts.append(b)
            off = self._aligned(off + b.numel())
        head = pickle.dumps((msg, metas))
        start = self._aligned(len(head))
        buf = torch.zeros(start + off, dtype=torch.uint8, device=self.wire)
        buf[:len(head)] = torch.frombuffer(bytearray(head), dtype=torch.uint8)
        for (_, _, o, n), b in zip(metas, parts):
            buf[start + o:start + o + n] = b.to(self.wire)
        size = torch.tensor([len(head), buf.numel()], dtype=torch.int64,
                            device=self.wire)
        dist.broadcast(size, 0)
        dist.broadcast(buf, 0)

    def _recv(self):
        size = torch.zeros(2, dtype=torch.int64, device=self.wire)
        dist.broadcast(size, 0)
        n_head, n = (int(x) for x in size.tolist())
        buf = torch.empty(n, dtype=torch.uint8, device=self.wire)
        dist.broadcast(buf, 0)
        msg, metas = pickle.loads(buf[:n_head].cpu().numpy().tobytes())
        start = self._aligned(n_head)
        tensors = [buf[start + o:start + o + nb].view(dtype).reshape(shape)
                   .clone() for dtype, shape, o, nb in metas]
        return self._decode(msg, tensors)

    # -- operations ----------------------------------------------------------

    def run(self, op: str, *args, **kw):
        """Rank 0: broadcast an operation and apply it here too; returns
        rank 0's result."""
        with self._lock:
            if self.closed:
                raise RuntimeError("the rank group is closed")
            drops = []
            while self._drops:
                drops.append(self._drops.popleft())
            tensors: list = []
            self._send(self._encode((op, args, kw, drops), tensors), tensors)
            return self._apply(op, self._resolve(args), self._resolve(kw),
                               drops)

    def _resolve(self, obj):
        """Rank 0's own arguments with each remote object made local."""
        if isinstance(obj, _Remote):
            return self.objs.get(obj.oid)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._resolve(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self._resolve(v) for k, v in obj.items()}
        return obj

    def follow(self) -> None:
        """Ranks 1..N-1: apply rank 0's operations until it stops."""
        while True:
            try:
                op, args, kw, drops = self._recv()
            except RuntimeError as e:  # rank 0's process is gone
                log.error(f"rank {self.rank}: rank 0 left the group ({e})")
                raise SystemExit(1) from None
            if op == "stop":
                return
            try:
                self._apply(op, args, kw, drops)
            except Exception:  # noqa: BLE001 — rank 0 raised it too
                log.exception(f"rank {self.rank}: operation {op} failed")

    def _apply(self, op: str, args, kw, drops):
        for oid in drops:
            self.objs.pop(oid, None)
        return getattr(self, "_op_" + op)(*args, **kw)

    def mesh(self, tp: int, dp: int, ep: int = 1, sp: int = 1,
             pp: int = 1) -> Mesh:
        check_mesh(tp, dp, ep, sp, pp)
        key = (tp, dp, ep, sp, pp)
        if key not in self.meshes:
            self.meshes[key] = Mesh(tp, dp, self.rank, self.world,
                                    self.backend, ep=ep, sp=sp, pp=pp)
        return self.meshes[key]

    def _op_model(self, oid, source, tp, dp, *args, ep=1, sp=1, pp=1):
        mesh = self.mesh(tp, dp, ep, sp, pp)
        if not mesh.member:
            return None
        cfg, full = _LOADERS[source](self, *args)
        _check_model(cfg, pp)
        local = shard_params_tp(full, mesh.tp_rank, tp, mesh.ep_rank, ep)
        del full
        if pp > 1:
            from .pp import shard_params_pp

            local = shard_params_pp(local, mesh.pp_rank, pp)
        self.objs[oid] = ShardModel(mesh, local, cfg)
        return self.objs[oid]

    def _op_eagle(self, oid, base: ShardModel, path: str, rank: int = 0):
        """An EAGLE head GGUF against base's shards: every rank loads the
        head against its target shard (sharing its embedding and lm_head)
        and keeps its shard of the head's layers; rank > 0 factors the
        head's lm_head (gathered whole) on every rank, replicated."""
        if base is None:
            return None
        from ..models.loader import load_eagle_gguf
        from ..speculative.eagle import with_lm_head_lr

        mesh = base.mesh
        _, head = load_eagle_gguf(path, base.model, base.cfg.llm,
                                  device=self.device)
        head = shard_eagle_tp(head, mesh.tp_rank, mesh.tp, base.model)
        if rank:
            head = with_lm_head_lr(head, _factored(head.lm_head, base, rank))
        self.objs[oid] = ShardEagle(mesh, head)
        return self.objs[oid]

    def _op_self_draft(self, oid, base: ShardModel, n_layers: int):
        if base is None:
            return None
        from ..speculative.chain import self_draft_config, self_draft_model

        draft = self_draft_model(base.model, n_layers)
        cfg = dataclasses.replace(base.cfg, llm=self_draft_config(
            base.cfg.llm, n_layers))
        self.objs[oid] = ShardModel(base.mesh, draft, cfg)
        return self.objs[oid]

    def _op_draft_head(self, oid, base: ShardModel, rank: int):
        """base with a factored head (replicated), factored from the
        whole lm_head on every rank."""
        if base is None:
            return None
        from ..speculative.chain import with_draft_head

        model = with_draft_head(base.model, _factored(base.model.lm_head,
                                                      base, rank))
        self.objs[oid] = ShardModel(base.mesh, model, base.cfg)
        return self.objs[oid]

    def _op_cache(self, oid, tp, dp, n_layers, n_slots, max_seq, n_kv_heads,
                  head_dim, n_pages=0, page_size=64, ep=1, sp=1, pp=1,
                  staged=True):
        mesh = self.mesh(tp, dp, ep, sp, pp)
        if not mesh.member:
            return None
        lo, hi = mesh.block(n_slots)
        layers = n_layers // pp if staged else n_layers
        args = (layers, hi - lo, max_seq, n_kv_heads // tp, head_dim,
                self.device)
        if n_pages:
            kv = PagedKVCache.create(*args, n_pages=n_pages // dp,
                                     page_size=page_size)
        elif sp > 1 and staged:
            kv = SeqShardCache.create(*args, sp=sp, sp_rank=mesh.sp_rank,
                                      comm=mesh.sp_comm)
        else:
            kv = KVCache.create(*args)
        self.objs[oid] = ShardCache(mesh, kv, n_slots, n_pages, staged)
        return self.objs[oid]

    def _op_call(self, oid, method: str, args, kw, keep=None):
        obj = self.objs.get(oid)
        if obj is None:  # a rank outside the object's mesh
            return None
        out = getattr(obj, method)(*args, **kw)
        if keep is not None:
            self.objs[keep] = out
        return out

    def _op_release(self):
        """Free what the dropped objects held (their drops came with this
        operation): their device memory back to CUDA."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _op_counts(self, reset: bool):
        """Every rank's kernel launch counts, [world, names], on every rank
        (then zeroed with reset)."""
        names = sorted(cuda_lib.LAUNCHES)
        t = torch.zeros(self.world, len(names), dtype=torch.int64,
                        device=self.wire)
        t[self.rank] = torch.tensor([cuda_lib.LAUNCHES[k] for k in names])
        dist.all_reduce(t)
        if reset:
            cuda_lib.reset_launch_counts()
        return [dict(zip(names, row)) for row in t.tolist()]

    # -- rank 0's front ----------------------------------------------------

    def _new_id(self) -> int:
        return next(self._ids)

    def _drop(self, oid: int) -> None:
        self._drops.append(oid)

    def load(self, path, tp: int, dp: int = 1, mxu: bool = False,
             ep: int = 1, source: str = "gguf", sp: int = 1, pp: int = 1
             ) -> tuple[ModelConfig, "TPModel"]:
        """A GGUF model dir (mxu: in the W8 format), or with source
        "hf_internvl" the text model of an HF InternVL checkpoint dir (its
        weights quantized to Q8_0 by every rank), sharded over a (tp, dp)
        mesh (ep > 1: an MoE model's experts split over ep groups of tp
        ranks in each dp block; sp > 1: the caches' positions split over
        sp ranks; pp > 1, alone: the layers over pp stages): (the global
        config, rank 0's TPModel)."""
        return self._model(source, tp, dp, ep, sp, pp, str(path), mxu)

    def preset(self, preset: str, quant: str, seed: int, tp: int,
               dp: int = 1, ep: int = 1, layers: int | None = None,
               sp: int = 1, pp: int = 1) -> tuple[ModelConfig, "TPModel"]:
        """Random weights (tools/bench_params.py, the same seed on every
        rank; layers: the depth cut), sharded over a (tp, dp) mesh (and
        ep, sp and pp, as load())."""
        return self._model("preset", tp, dp, ep, sp, pp, preset, quant,
                           seed, layers)

    def _model(self, source, tp, dp, ep, sp, pp, *args):
        oid = self._new_id()
        shard = self.run("model", oid, source, tp, dp, *args, ep=ep, sp=sp,
                         pp=pp)
        return shard.cfg, TPModel(self, oid, shard)

    def eagle(self, model: "TPModel", path, rank: int = 0) -> "TPEagleHead":
        """An EAGLE head GGUF dir against model's shards (rank > 0: its
        drafting logits through a factored head of that rank)."""
        oid = self._new_id()
        shard = self.run("eagle", oid, model, str(path), rank)
        return TPEagleHead(self, oid, shard)

    def replica_eagle(self, model: "TPModel") -> "TPEagleHead":
        """The exact-replica head of a 1-layer model (self_draft(m, 1)),
        on its shards."""
        oid = self._new_id()
        shard = self.run("call", model.oid, "replica_eagle", (), {},
                         keep=oid)
        return TPEagleHead(self, oid, shard)

    def self_draft(self, model: "TPModel", n_layers: int) -> "TPModel":
        if model.mesh.pp > 1:
            raise ValueError("self-draft speculation does not compose with "
                             "pp (the first layers lie on one stage); use a "
                             "separate draft model")
        oid = self._new_id()
        return TPModel(self, oid, self.run("self_draft", oid, model,
                                           n_layers))

    def with_draft_head(self, model: "TPModel", rank: int) -> "TPModel":
        oid = self._new_id()
        return TPModel(self, oid, self.run("draft_head", oid, model, rank))

    def release(self) -> None:
        """Drop on every rank the objects whose handles rank 0 no longer
        holds (models, caches, snapshots), then give their device memory
        back (an evicted model's shards and caches)."""
        gc.collect()  # runs the finalizers of unreachable handles
        self.run("release")

    def launch_counts(self, reset: bool = False) -> list[dict]:
        """Each rank's kernel launch counts (ops/cuda_lib.py)."""
        return self.run("counts", reset)

    def close(self) -> None:
        """Stop the followers and leave the process group (rank 0)."""
        if self.closed:
            return
        if self.followers is not None:
            self.followers.closing = True
        self.run("stop")
        self.closed = True
        if self.followers is not None:
            self.followers.close()
        dist.destroy_process_group()
        if self.threads_before:
            torch.set_num_threads(self.threads_before)

    def _op_stop(self):
        return None


class _T(NamedTuple):
    """An operation's tensor: its index in the buffer, and whether it
    lives on the cpu (else on the receiving rank's device)."""

    i: int
    cpu: bool


class _Ref(NamedTuple):
    """An operation's reference to an object every rank keeps by id."""

    oid: int


class _Remote:
    """Rank 0's handle on an object every rank of its mesh keeps; the
    ranks drop theirs when this handle goes (with rank 0's next
    operation)."""

    def __init__(self, group: RankGroup, oid: int):
        self.group, self.oid = group, oid
        weakref.finalize(self, group._drop, oid)

    def _call(self, method: str, *args, keep=None, **kw):
        return self.group.run("call", self.oid, method, args, kw, keep=keep)


class TPModel(_Remote):
    """Rank 0's model over a rank group: LlamaModel's call, broadcast and
    run by every rank on its shards; `llm` is the global config."""

    def __init__(self, group: RankGroup, oid: int, shard: ShardModel):
        super().__init__(group, oid)
        self.shard = shard
        self.mesh = shard.mesh
        self.llm = shard.cfg.llm
        self.embed = _TPEmbedding(self)

    def to(self, device) -> "TPModel":
        return self

    def __call__(self, kv: "TPCache", tokens: torch.Tensor,
                 positions: torch.Tensor, **kw):
        return self._call("forward", kv, tokens, positions, **kw)

    def create_cache(self, n_layers: int, n_slots: int, max_seq: int,
                     n_kv_heads: int, head_dim: int, *, n_pages: int = 0,
                     page_size: int = 64, staged: bool = True) -> "TPCache":
        """KVCache.create / PagedKVCache.create (n_pages > 0) over this
        model's mesh: each rank its kv heads of its block's slots, under
        sp its slice of the positions (the dense cache only), under pp
        its stage's layers (staged=False: every layer on every stage and
        every position on every sp rank, a replicated EAGLE head's
        cache)."""
        m = self.mesh
        if n_pages and m.sp > 1:
            raise ValueError("the paged pool is not sequence-parallel: "
                             "paged KV + sequence parallel unsupported")
        for what, n, by in (("kv heads", n_kv_heads, m.tp),
                            ("slots", n_slots, m.dp),
                            ("pages", n_pages, m.dp),
                            ("positions", max_seq, m.sp if staged else 1),
                            ("layers", n_layers, m.pp if staged else 1)):
            if n % by:
                raise ValueError(f"{n} {what} do not split over {by} ranks")
        oid = self.group._new_id()
        shard = self.group.run("cache", oid, m.tp, m.dp, n_layers, n_slots,
                               max_seq, n_kv_heads, head_dim,
                               n_pages=n_pages, page_size=page_size,
                               ep=m.ep, sp=m.sp, pp=m.pp, staged=staged)
        cls = TPPagedCache if n_pages else TPCache
        return cls(self.group, oid, shard, n_slots, n_pages, n_layers)


class _TPEmbedding:
    """A TPModel's embedding table as the scheduler and a VLM read it:
    lookup(tokens) runs the vocab-sharded lookup on every rank and gives
    rank 0 the rows."""

    def __init__(self, model: TPModel):
        self._model = weakref.ref(model)

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._model()._call("embed_rows", tokens)


class TPEagleHead(_Remote):
    """Rank 0's EAGLE head over a rank group: eagle_forward (speculative/
    eagle.py) broadcast and run by every rank on its head shards and its
    cache shard; `llm` is the head's global config."""

    remote = True

    def __init__(self, group: RankGroup, oid: int, shard: ShardEagle):
        super().__init__(group, oid)
        self.shard = shard
        head = shard.head
        self.llm = dataclasses.replace(
            head.llm, n_heads=head.llm.n_heads * shard.mesh.tp,
            n_kv_heads=head.llm.n_kv_heads * shard.mesh.tp,
            kv_dim=head.llm.kv_dim * shard.mesh.tp)
        width = (head.lm_head_lr[1].out_features if head.lm_head_lr
                 is not None else head.lm_head.out_features)
        if head.lm_head_lr is None and width != head.llm.vocab_size:
            width *= shard.mesh.tp  # a vocab-sharded lm_head
        self.head_width = width

    def to(self, device) -> "TPEagleHead":
        return self

    def forward(self, kv: "TPCache", tokens: torch.Tensor,
                features: torch.Tensor, positions: torch.Tensor, **kw):
        return self._call("forward", kv, tokens, features, positions, **kw)


class TPCache(_Remote, KVCache):
    """Rank 0's cache over a rank group: the cache's interface, each
    operation broadcast and applied by every rank to its shard. pos and
    mask are the whole batch's (under dp put together from the
    blocks)."""

    def __init__(self, group: RankGroup, oid: int, shard: ShardCache,
                 n_slots: int, n_pages: int = 0, n_layers: int = 0):
        _Remote.__init__(self, group, oid)
        self.shard = shard
        self._n_slots = n_slots
        self._n_pages = n_pages
        self._n_layers = n_layers or shard.kv.n_layers

    @property
    def pos(self) -> torch.Tensor:
        if self.shard.mesh.dp == 1:
            return self.shard.kv.pos
        return self._call("pos")

    @property
    def mask(self) -> torch.Tensor:
        if (self.shard.mesh.dp == 1
                and not isinstance(self.shard.kv, SeqShardCache)):
            return self.shard.kv.mask
        return self._call("mask")

    @property
    def n_layers(self) -> int:
        return self._n_layers

    @property
    def n_slots(self) -> int:
        return self._n_slots

    @property
    def max_seq(self) -> int:
        return self.shard.kv.max_seq

    @property
    def device(self) -> torch.device:
        return self.shard.kv.device

    @property
    def n_kv_heads(self) -> int:
        return self.shard.kv.n_kv_heads * self.shard.mesh.tp

    @property
    def head_dim(self) -> int:
        return self.shard.kv.head_dim

    def reset_slot(self, slot: int) -> None:
        self._call("reset_slot", slot)

    def rollback(self, n, active=None) -> None:
        self._call("rollback", n, active)

    def commit_tokens(self, slot_indices, src_positions, n_accept) -> None:
        self._call("commit_tokens", None, src_positions, n_accept)

    def save_slot_prefix(self, slot: int, n: int) -> dict:
        """A handle on every rank's snapshot of its heads, in place of the
        tensors; restore_slot_prefix takes it back."""
        handle = _Remote(self.group, self.group._new_id())
        self._call("save_slot_prefix", slot, n, keep=handle.oid)
        return {"n": n, "handle": handle}

    def restore_slot_prefix(self, slot: int, saved: dict) -> None:
        self._call("restore_slot_prefix", slot, saved)

    def gathered(self) -> dict:
        """ShardCache.gathered: the whole cache from every rank's part."""
        return self._call("gathered")

    def snapshot_from_host(self, host: dict) -> dict:
        """A handle on every rank's heads of a whole host snapshot (the
        arrays go to every rank, each keeps its heads)."""
        self.check_snapshot(host)
        handle = _Remote(self.group, self.group._new_id())
        whole = {"n": int(host["n"]),
                 **{k: torch.as_tensor(host[k]) for k in (
                     "k", "v", "k_scale", "v_scale")}}
        self._call("import_prefix", whole, keep=handle.oid)
        return {"n": whole["n"], "handle": handle}

    def snapshot_to_host(self, saved: dict) -> dict:
        """A handle's snapshot with every head in the global order, as
        host arrays: what one device's save_slot_prefix holds."""
        whole = self._call("export_prefix", saved)
        return {"n": int(whole["n"]),
                **{k: whole[k].cpu().numpy() for k in (
                    "k", "v", "k_scale", "v_scale")}}


class TPPagedCache(TPCache, PagedKVCache):
    """TPCache over the paged pool."""

    @property
    def n_pages(self) -> int:
        return self._n_pages

    @property
    def max_pages(self) -> int:
        return self.shard.kv.max_pages

    @property
    def page_size(self) -> int:
        return self.shard.kv.page_size

    @property
    def max_seq(self) -> int:
        return self.shard.kv.max_seq

    def assign_pages(self, table: np.ndarray) -> None:
        self._call("assign_pages", np.asarray(table, np.int32))


# ---------------------------------------------------------------------------
# starting a rank group, the follower loop, and the sharded entry points
# ---------------------------------------------------------------------------


def start_rank_group(world: int, backend: str,
                     device: str | torch.device = "cuda",
                     threads: int | None = None) -> RankGroup:
    """Rank 0 of `world` ranks: start ranks 1..world-1 and join them.
    On cuda the kernel library is built first (the followers load it).
    On the cpu the ranks share the cores: each rank, this one too, takes
    `threads` (default this process's threads over the ranks)."""
    dev = torch.device(device)
    check_backend(backend, world, dev)
    dev = rank_device(0, dev.type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        cuda_lib.build()
    before = torch.get_num_threads()
    if dev.type == "cpu":
        threads = threads or max(before // world, 1)
        torch.set_num_threads(threads)
    followers = Followers(world, backend, dev.type, threads or before)
    try:
        init_distributed(0, world, followers.addr, backend)
    except BaseException:
        followers.closing = True
        followers.kill()
        torch.set_num_threads(before)
        raise
    group = RankGroup(0, world, backend, dev, followers)
    group.threads_before = before
    return group


def follower_main(rank: int, world: int, addr: str, backend: str,
                  device_type: str, threads: int, parent_pid: int) -> None:
    """A follower's process: join the group, apply rank 0's operations
    until it stops."""
    torch.set_num_threads(threads)
    watch_parent(parent_pid)
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(rank, world, addr, backend)
    try:
        with torch.no_grad():
            RankGroup(rank, world, backend, dev).follow()
    finally:
        dist.destroy_process_group()


def tp_forward(model: TPModel, kv: TPCache, tokens: torch.Tensor,
               positions: torch.Tensor, **kw):
    """The sharded forward (the JAX tp_forward): LlamaModel.forward's
    arguments and outputs, run by every rank on its shards."""
    return model(kv, tokens, positions, **kw)


def tp_prefill(model: TPModel, tokens: torch.Tensor,
               positions: torch.Tensor, kv: TPCache) -> torch.Tensor:
    """One sharded prefill chunk: the last position's logits [S, vocab]."""
    return model(kv, tokens, positions, logits_mode="last")


@torch.no_grad()
def tp_decode_scan(model: TPModel, tokens: torch.Tensor, kv: TPCache,
                   n_steps: int) -> torch.Tensor:
    """Greedy-decode n_steps tokens for every slot over the rank group
    (engine/loops.py decode_scan; eager: its steps hold collectives).
    Returns [S, n_steps] int32."""
    out, tok = [], tokens
    for _ in range(n_steps):
        pos = kv.pos.to(torch.int64)[:, None]
        tok = model(kv, tok[:, None], pos, logits_mode="argmax")
        out.append(tok)
    return torch.stack(out, dim=1)
