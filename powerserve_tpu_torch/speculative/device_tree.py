"""Batched token-tree speculation on the device.

Generalizes speculative/chain.py (width-1 trees) to static tree
topologies (TreeTemplate). Per speculative step, for every slot at once:
  1. draft: one batched draft forward per depth level of the template;
     the children of a level's nodes take the draft's top-w tokens after
     them (or, with sample="wor", w samples without replacement from its
     distribution). The deepest level is forwarded only to write its K/V,
     so the draft cache stays complete when a whole path is accepted.
  2. verify: one target forward over all N nodes with the ancestor
     intra mask.
  3. accept: a walk down the static child table, from the root, while
     some child carries the target's token after its parent (greedy:
     the argmax; sample=True: the target's own sample with the slot's
     sampler settings, exact-match acceptance); sample="wor" verifies by
     recursive rejection over the rank-ordered children.
  4. commit: both caches roll back to the committed length c and the
     accepted path's entries move to c, c + 1, ... (commit_tokens).

KV bookkeeping per step: node i is written at cache position c + i in
both caches, its RoPE position is c + depth(i); a draft level attends
with the committed mask as it was at the tree's start (kept in a static
buffer: each level's forward marks its own nodes) plus its rows'
ancestors-or-self among the nodes, a verify with the cache's mask plus
each node's ancestors-or-self; both through the tree mode of
csrc/flash_decode.cu (ops/flash_decode.py). A verify over the paged
pool writes its nodes, then attends through the paged tree mode (one
kernel a layer, the function of the dense cache's verify), where the
JAX package defers the write and merges the nodes' K/V in flight; the
forward's deferred route takes a tree's ancestor rows too.

The JAX package runs the steps inside one lax.scan (its window-KV route
is not ported: the port commits every step). Here a greedy step, every
level's forward, the top-k assignments, the verify, the acceptance walk,
the rollbacks and the commits, is one CUDA graph, replayed once per step
(engine/graphs.py); so is the scheduler's sampled step (tree_sample_body),
whose draws come from per-slot Philox streams through csrc/sample.cu;
tree_spec_scan(sample=...) runs the same steps eagerly. All read the host
once per block.

Trees raise tokens per step over chains at equal verify cost: siblings
hedge the draft across its top-k at each depth, so one mispredicted
argmax no longer ends the step.
"""

from __future__ import annotations

import weakref
from typing import Callable

import numpy as np
import torch

from ..core.config import ModelConfig
from ..engine.graphs import graphs_of, steps_capacity
from ..kv.cache import KVCache
from ..models.llama import DECODE_MAX_TQ, LlamaModel
from ..sampling.sampler import (DrawState, categorical_from_dist,
                                gumbel_draws, sample_dist_batched,
                                uniform_draws)
from .chain import ChainSpecEngine, draft_fuse

__all__ = ["TreeTemplate", "tree_spec_scan", "tree_sample_step",
           "tree_sample_body",
           "DeviceTreeEngine", "MAX_NODES"]

# a verify is one forward over every node, and decode-sized forwards
# attend through flash-decode: at most DECODE_MAX_TQ rows
MAX_NODES = DECODE_MAX_TQ


class TreeTemplate:
    """Static speculation-tree topology.

    parents[i] is the node index of i's parent (parents[0] == -1: node
    0 is the root, holding the last committed token); nodes are in
    BFS order (parent < child). ranks[i] selects which draft candidate
    the child takes: the rank-r child of p gets the draft's r-th most
    probable token after p. Ranks within one parent must be 0..w-1.
    At most MAX_NODES nodes.
    """

    def __init__(self, parents, ranks):
        parents = list(parents)
        ranks = list(ranks)
        N = len(parents)
        if N < 1 or parents[0] != -1:
            raise ValueError("node 0 must be the root (parent -1)")
        if len(ranks) != N:
            raise ValueError(f"{len(ranks)} ranks for {N} nodes")
        if N > MAX_NODES:
            raise ValueError(f"a tree of {N} nodes: the verify attends "
                             f"through flash-decode, which takes at most "
                             f"{MAX_NODES} nodes")
        depths = [0] * N
        children: list[list[tuple[int, int]]] = [[] for _ in range(N)]
        for i in range(1, N):
            p = parents[i]
            if not 0 <= p < i:
                raise ValueError(f"node {i}: parent {p} must precede it")
            depths[i] = depths[p] + 1
            children[p].append((ranks[i], i))
        for p in range(N):
            children[p].sort()
            got = [r for r, _ in children[p]]
            if got != list(range(len(got))):
                raise ValueError(f"node {p}: child ranks {got} not 0..w-1")
        self.parents = parents
        self.ranks = ranks
        self.n_nodes = N
        self.depths = np.asarray(depths, np.int32)
        self.max_depth = int(self.depths.max())
        # levels[d] = node indices at depth d (ascending)
        self.levels = [np.asarray([i for i in range(N) if depths[i] == d],
                                  np.int32)
                       for d in range(self.max_depth + 1)]
        # child table [N, Cmax] (-1 pad), columns in rank order: the
        # acceptance walk prefers lower ranks on ties
        cmax = max((len(ch) for ch in children), default=0)
        self.max_children = max(cmax, 1)
        tab = np.full((N, self.max_children), -1, np.int32)
        for p in range(N):
            for r, i in children[p]:
                tab[p, r] = i
        self.child_table = tab
        # ancestor-or-self mask [N, N]
        anc = np.zeros((N, N), bool)
        for i in range(N):
            j = i
            while j >= 0:
                anc[i, j] = True
                j = parents[j]
        self.anc = anc
        # per-level draft assignments: (row-in-level, child, rank)
        self.assignments = []
        for d in range(self.max_depth + 1):
            lev = self.levels[d]
            rows = {int(n): r for r, n in enumerate(lev)}
            a = [(rows[p], i, r)
                 for p in lev for r, i in children[int(p)]]
            self.assignments.append(a)
        # top-k width needed at each level's draft
        self.level_topk = [max((r for _, _, r in a), default=-1) + 1
                           for a in self.assignments]
        self._tables: dict = {}  # device -> _Consts

    @classmethod
    def from_widths(cls, widths) -> "TreeTemplate":
        """Every node at depth d gets widths[d] children.

        from_widths([1]*k) is the k-chain; from_widths([2, 1, 1]) hedges
        the first step across the draft's top-2."""
        parents, ranks = [-1], [0]
        level = [0]
        for w in widths:
            nxt = []
            for p in level:
                for r in range(int(w)):
                    nxt.append(len(parents))
                    parents.append(p)
                    ranks.append(r)
            level = nxt
        return cls(parents, ranks)

    def key(self) -> tuple:
        return (tuple(self.parents), tuple(self.ranks))

    @property
    def is_chain(self) -> bool:
        return self.n_nodes == self.max_depth + 1


class _Consts:
    """A template's tables as device tensors."""

    def __init__(self, tpl: TreeTemplate, dev: torch.device):
        t = lambda a, dt=torch.int64: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev)
        self.tpl = tpl
        self.depths = t(tpl.depths)
        self.nodes = torch.arange(tpl.n_nodes, device=dev)
        self.child_tab = t(tpl.child_table)
        self.anc = t(tpl.anc, torch.bool)
        self.levels = [t(lev) for lev in tpl.levels]
        self.level_anc = [t(tpl.anc[lev], torch.bool) for lev in tpl.levels]
        # per level: (rows in the level, children, ranks) of its draft
        self.assign = [tuple(t([x[i] for x in a]) for i in range(3))
                       for a in tpl.assignments]


def _consts_of(tpl: TreeTemplate, dev: torch.device) -> _Consts:
    """The template's tables on `dev`, built once per template and
    device (before a graph captures a step that reads them)."""
    c = tpl._tables.get(str(dev))
    if c is None:
        c = tpl._tables[str(dev)] = _Consts(tpl, dev)
    return c


def _draft_levels(draft: LlamaModel, d_kv: KVCache, k: _Consts,
                  tokens: torch.Tensor, c: torch.Tensor,
                  active: torch.Tensor, mask0: torch.Tensor,
                  choose: Callable) -> None:
    """Every level's draft forward (mask0: the committed mask at the
    tree's start); after level d < D, choose(d, logits [S, ln, V])
    returns the candidates [S, ln, w] whose assigned ranks become the
    next level's tokens, written into tokens [S, N] in place."""
    tpl = k.tpl
    fuse = draft_fuse(draft.llm)
    act = active[:, None]
    keys = torch.where(act, c[:, None] + k.nodes[None, :], -1)
    for d in range(tpl.max_depth + 1):
        lev = k.levels[d]
        last = d == tpl.max_depth
        logits = draft(d_kv, tokens[:, lev],
                       torch.where(act, c[:, None] + k.depths[lev], -1),
                       active=active,
                       cache_positions=torch.where(act, c[:, None] + lev, -1),
                       intra_mask=k.level_anc[d], key_positions=keys,
                       attn_mask=mask0,
                       logits_mode="none" if last else "all",
                       fuse_layers=fuse)
        if not last:
            rows, children, ranks = k.assign[d]
            cand = choose(d, logits)
            tokens[:, children] = cand[:, rows, ranks]


def _greedy_walk(k: _Consts, tokens: torch.Tensor, sampled: torch.Tensor
                 ) -> torch.Tensor:
    """The accepted path [S, D + 1] (node ids, -1 past its end): from the
    root, the lowest-ranked child whose token is the target's after its
    parent."""
    S = tokens.shape[0]
    cur = torch.zeros(S, dtype=torch.int64, device=tokens.device)
    alive = torch.ones(S, dtype=torch.bool, device=tokens.device)
    chain = [cur]
    for _ in range(k.tpl.max_depth):
        cand = k.child_tab[cur]  # [S, Cmax] rank order
        cand_tok = tokens.gather(1, cand.clamp(min=0))
        tgt = sampled.gather(1, cur[:, None])
        m = (cand >= 0) & (cand_tok == tgt) & alive[:, None]
        has = m.any(dim=1)
        pick = torch.argmax(m.int(), dim=1)  # the first: lowest rank
        child = cand.gather(1, pick[:, None])[:, 0]
        cur = torch.where(has, child, cur)
        alive = alive & has
        chain.append(torch.where(has, child, -1))
    return torch.stack(chain, dim=1)


def _commit(t_kv: KVCache, d_kv: KVCache, c: torch.Tensor,
            chain_m: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Both caches back to c, then the accepted path's entries to the
    front; returns the committed counts [S] (0 for inactive slots)."""
    S = c.shape[0]
    n_acc = (chain_m[:, 1:] >= 0).sum(dim=1)
    src = torch.where(chain_m >= 0, c[:, None] + chain_m, -1)
    n_commit = torch.where(active, n_acc + 1, 0)
    slots = torch.arange(S, device=c.device)
    for kv in (d_kv, t_kv):
        kv.rollback(kv.pos.long() - c, active=active)
        kv.commit_tokens(slots, src, n_commit)
    return n_commit


def _greedy_step(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                 d_kv: KVCache, tpl: TreeTemplate, S: int, cap: int
                 ) -> tuple:
    """The body of one greedy tree step over every slot and its buffers:
    root [S] and active [S] in; the step's tokens [S, D + 1] and counts
    [S] to row `step` of tokens [cap, S, D + 1] and counts [cap, S]; the
    next root back into root."""
    dev = t_kv.device
    k = _consts_of(tpl, dev)
    D, N = tpl.max_depth, tpl.n_nodes
    V = target.llm.vocab_size
    z = lambda *shape, dtype=torch.int64: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    bufs = dict(root=z(S), active=torch.ones(S, dtype=torch.bool, device=dev),
                tokens=z(cap, S, D + 1), counts=z(cap, S), step=z(1),
                mask0=torch.zeros_like(d_kv.mask))
    refs = [weakref.ref(o) for o in (target, draft, t_kv, d_kv)]
    b = bufs

    def body():
        tgt, drf, tkv, dkv = (r() for r in refs)
        root, active = b["root"], b["active"]
        c = dkv.pos.long()
        b["mask0"].copy_(dkv.mask)
        tokens = torch.zeros(S, N, dtype=torch.int64, device=dev)
        tokens[:, 0] = root
        _draft_levels(drf, dkv, k, tokens, c, active, b["mask0"],
                      lambda d, lg: torch.topk(
                          lg[:, :, :V], tpl.level_topk[d], dim=-1).indices)
        act = active[:, None]
        sampled = tgt(tkv, tokens, torch.where(act, c[:, None] + k.depths,
                                               -1),
                      active=active,
                      cache_positions=torch.where(act, c[:, None] + k.nodes,
                                                  -1),
                      intra_mask=k.anc, logits_mode="argmax_all").long()
        chain_m = _greedy_walk(k, tokens, sampled)
        emit = torch.where(chain_m >= 0,
                           sampled.gather(1, chain_m.clamp(min=0)), -1)
        cur = chain_m.clamp(min=0).amax(dim=1)  # the path's last node
        root.copy_(torch.where(active, sampled.gather(1, cur[:, None])[:, 0],
                               root))
        count = _commit(tkv, dkv, c, chain_m, active)
        b["tokens"].index_copy_(0, b["step"], emit[None])
        b["counts"].index_copy_(0, b["step"], count[None])
        b["step"].add_(1)

    return body, bufs


def _gumbel(draws: DrawState | None, S: int, n: int, V: int,
            device: torch.device) -> torch.Tensor:
    """[S, n, V] Gumbel(0, 1) draws, slot i's n rows from its stream;
    zeros without draws."""
    return gumbel_draws(draws, S * n, V, device).reshape(S, n, V)


def _wor_accept_walk(tokens: torch.Tensor, q_dists: torch.Tensor,
                     p_dists: torch.Tensor, k: _Consts, active: torch.Tensor,
                     draws: DrawState | None, root: torch.Tensor) -> tuple:
    """Recursive-rejection acceptance over rank-ordered WOR candidates:
    a child t is accepted with probability min(1, p_t(x_t) / q_t(x_t));
    on its rejection p_{t+1} = norm((p_t - q_t)^+) and q_{t+1} = norm(q_t
    without x_t); when every child is rejected a residual sample is
    emitted and the walk stops. tokens [S, N]; q_dists, p_dists [S, N,
    V] the draft's and the target's distributions after each node.
    Returns (chain_m [S, D + 1] accepted node ids (-1 dead), final_tok
    [S]: the residual or bonus sample after the last accepted node)."""
    tpl = k.tpl
    S = tokens.shape[0]
    dev = tokens.device
    srows = torch.arange(S, device=dev)
    cur = torch.zeros(S, dtype=torch.int64, device=dev)
    alive = active.clone()
    final_tok = root
    p_res = p_dists[:, 0]
    chain = [cur]
    for _ in range(tpl.max_depth):
        cand = k.child_tab[cur]  # [S, Cmax] rank order
        q_t = q_dists[srows, cur]  # [S, V]
        u = uniform_draws(draws, S, tpl.max_children, dev)
        accepted = torch.zeros(S, dtype=torch.bool, device=dev)
        chosen = cur
        for t in range(tpl.max_children):
            ch = cand[:, t]
            x_t = tokens.gather(1, ch.clamp(min=0)[:, None])[:, 0]
            qx = q_t[srows, x_t]
            px = p_res[srows, x_t]
            # a child counts only if it exists and still has q-mass (the
            # draws without replacement can exhaust the support)
            real = alive & ~accepted & (ch >= 0) & (qx > 1e-12)
            acc = real & (u[:, t] * qx < px)
            chosen = torch.where(acc, ch, chosen)
            accepted = accepted | acc
            rej = (real & ~acc)[:, None]
            p_new = torch.clamp(p_res - q_t, min=0.0)
            ps = p_new.sum(dim=-1, keepdim=True)
            p_new = torch.where(ps > 1e-12,
                                p_new / torch.clamp(ps, min=1e-30), p_res)
            p_res = torch.where(rej, p_new, p_res)
            q_z = q_t.scatter(1, x_t[:, None], 0.0)
            qs = q_z.sum(dim=-1, keepdim=True)
            q_z = torch.where(qs > 1e-12, q_z / torch.clamp(qs, min=1e-30),
                              q_z)
            q_t = torch.where(rej, q_z, q_t)
        res = categorical_from_dist(p_res, draws)
        final_tok = torch.where(alive & ~accepted, res, final_tok)
        chain.append(torch.where(accepted, chosen, -1))
        p_next = p_dists[srows, chosen]
        p_res = torch.where(accepted[:, None], p_next, p_res)
        cur = torch.where(accepted, chosen, cur)
        alive = alive & accepted
    # a leaf (or a whole accepted path) emits the bonus or residual
    res = categorical_from_dist(p_res, draws)
    final_tok = torch.where(alive, res, final_tok)
    return torch.stack(chain, dim=1), final_tok


def tree_sample_step(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                     d_kv: KVCache, tpl: TreeTemplate, root: torch.Tensor,
                     active: torch.Tensor, draws: DrawState | None,
                     temp: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor, wor: bool = False,
                     mask0: torch.Tensor | None = None) -> tuple:
    """One tree step over a batch of slots with their sampler settings
    ([S] each) and streams (draws; None: every slot at temperature <= 0,
    nothing drawn). By default greedy top-k children, a child accepted
    when its token equals the target's sample after its parent; with
    wor, children drawn without replacement from the draft's
    distribution and recursive-rejection acceptance. mask0: a buffer for
    the committed mask (default a new one). Returns (emitted [S, D + 1]
    (-1 past each count, everywhere for inactive slots), counts [S], next
    root [S])."""
    S, dev = root.shape[0], root.device
    k = _consts_of(tpl, dev)
    N, V = tpl.n_nodes, target.llm.vocab_size
    c = d_kv.pos.long()
    mask0 = d_kv.mask.clone() if mask0 is None else mask0.copy_(d_kv.mask)
    tokens = torch.zeros(S, N, dtype=torch.int64, device=dev)
    tokens[:, 0] = root
    q_dists = torch.zeros(S, N, V, device=dev) if wor else None

    def dists(logits, n):
        rep = lambda a: a.repeat_interleave(n)  # noqa: E731
        return sample_dist_batched(
            logits.reshape(S * n, -1)[:, :V], rep(temp), rep(top_k),
            rep(top_p), vocab_size=V).reshape(S, n, V)

    def choose(d, logits):
        w = tpl.level_topk[d]
        if not wor:
            return torch.topk(logits[:, :, :V], w, dim=-1).indices
        # Gumbel top-k of the draft's distribution q: draws without
        # replacement in rank order, what the acceptance's q-zeroing
        # assumes
        lev = k.levels[d]
        q_rows = dists(logits, len(lev))
        q_dists[:, lev] = q_rows
        g = _gumbel(draws, S, len(lev), V, dev)
        scores = torch.where(q_rows > 0, torch.log(q_rows) + g,
                             float("-inf"))
        return torch.topk(scores, w, dim=-1).indices

    _draft_levels(draft, d_kv, k, tokens, c, active, mask0, choose)
    act = active[:, None]
    logits = target(t_kv, tokens, torch.where(act, c[:, None] + k.depths, -1),
                    active=active,
                    cache_positions=torch.where(act, c[:, None] + k.nodes, -1),
                    intra_mask=k.anc, logits_mode="all")
    p = dists(logits, N)
    if wor:
        chain_m, final_tok = _wor_accept_walk(tokens, q_dists, p, k, active,
                                              draws, root)
        acc_toks = torch.where(chain_m[:, 1:] >= 0,
                               tokens.gather(1, chain_m[:, 1:].clamp(min=0)),
                               -1)
        emit = torch.cat([acc_toks, torch.full_like(acc_toks[:, :1], -1)],
                         dim=1)
        n_acc = (chain_m[:, 1:] >= 0).sum(dim=1)
        lane = torch.arange(tpl.max_depth + 1, device=dev)[None, :]
        emit = torch.where(lane == n_acc[:, None], final_tok[:, None], emit)
        new_root = torch.where(active, final_tok, root)
    else:
        sampled = categorical_from_dist(p.reshape(S * N, V),
                                        draws).reshape(S, N)
        chain_m = _greedy_walk(k, tokens, sampled)
        emit = torch.where(chain_m >= 0,
                           sampled.gather(1, chain_m.clamp(min=0)), -1)
        cur = chain_m.clamp(min=0).amax(dim=1)
        new_root = torch.where(active,
                               sampled.gather(1, cur[:, None])[:, 0], root)
    count = _commit(t_kv, d_kv, c, chain_m, active)
    return torch.where(act, emit, -1), count, new_root


def tree_sample_body(target: LlamaModel, draft: LlamaModel,
                     t_kv: KVCache, d_kv: KVCache, bufs: dict,
                     tpl: TreeTemplate, wor: bool, draws: DrawState | None):
    """The body of one tree_sample_step over the scheduler's buffers,
    replayed as one CUDA graph: reads bufs root, active, temp, top_k and
    top_p ([S]) and the mask buffer mask0 ([S, T]); writes the step's
    emitted [S, D + 1] and counts [S] to row `step` of bufs spec_emitted
    [H, S, D + 1] and spec_counts [H, S], and the next root to bufs root.
    Its draws come from `draws` (None: every slot greedy)."""
    b = bufs
    step = b["step"]

    def body():
        emit, count, root = tree_sample_step(
            target, draft, t_kv, d_kv, tpl, b["root"], b["active"], draws,
            b["temp"], b["top_k"], b["top_p"], wor, b["mask0"])
        b["spec_emitted"].index_copy_(0, step, emit[None])
        b["spec_counts"].index_copy_(0, step, count[None])
        b["root"].copy_(root)
        step.add_(1)

    return body


@torch.no_grad()
def tree_spec_scan(target: LlamaModel, draft: LlamaModel, t_kv: KVCache,
                   d_kv: KVCache, root: torch.Tensor, n_steps: int,
                   template: TreeTemplate,
                   active: torch.Tensor | None = None,
                   draws: DrawState | None = None,
                   temp: torch.Tensor | None = None,
                   top_k: torch.Tensor | None = None,
                   top_p: torch.Tensor | None = None,
                   sample=False) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """n_steps tree-speculation steps for every slot of the caches.

    root: int64 [S], each slot's last committed token; active: bool [S]
    (default all). sample False: greedy drafting and verification, each
    step a replay of one CUDA graph (kept with t_kv); True: exact-match
    acceptance against the target's samples; "wor": draws without
    replacement and recursive rejection (tree_sample_step; draws the
    slots' streams, temp, top_k and top_p [S] their sampler settings),
    eager.
    Returns (emitted [n_steps, S, D + 1], counts [n_steps, S], root [S])
    on the device: step i emitted emitted[i, s, :counts[i, s]]."""
    S, dev = root.shape[0], root.device
    if active is None:
        active = torch.ones(S, dtype=torch.bool, device=dev)
    if sample:
        emitted, counts = [], []
        for _ in range(n_steps):
            emit, count, root = tree_sample_step(
                target, draft, t_kv, d_kv, template, root, active,
                draws, temp, top_k, top_p, sample == "wor")
            emitted.append(emit)
            counts.append(count)
        return torch.stack(emitted), torch.stack(counts), root
    cap = steps_capacity(n_steps)
    g = graphs_of(t_kv).step(
        ("tree", S, template.key(), cap),
        lambda: _greedy_step(target, draft, t_kv, d_kv, template, S, cap),
        deps=(target, draft, d_kv))
    b = g.bufs
    b["root"].copy_(root)
    b["active"].copy_(active)
    b["step"].zero_()
    for _ in range(n_steps):
        g()
    return (b["tokens"][:n_steps].clone(), b["counts"][:n_steps].clone(),
            b["root"].clone())


class DeviceTreeEngine(ChainSpecEngine):
    """One stream: prefill both models, then emit tokens in blocks of
    greedy tree steps (one host read per block), through ChainSpecEngine's
    caches, prefill and block loop."""

    def __init__(self, target: LlamaModel, target_cfg: ModelConfig,
                 draft: LlamaModel | None = None, self_draft_layers: int = 0,
                 template: TreeTemplate | None = None, block_steps: int = 8,
                 max_seq: int = 0, prefill_chunk: int = 128,
                 device: str | torch.device | None = None):
        tpl = template or TreeTemplate.from_widths([2, 1, 1])
        super().__init__(target, target_cfg, draft, self_draft_layers,
                         k=tpl.max_depth, block_steps=block_steps,
                         max_seq=max_seq, prefill_chunk=prefill_chunk,
                         device=device)
        self.template = tpl
        self.n_nodes = self.overhang = tpl.n_nodes  # one tree's nodes

    def scan(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return tree_spec_scan(self.target, self.draft, self.t_kv, self.d_kv,
                              self._root, self.block_steps, self.template)
